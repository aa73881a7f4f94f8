"""Plain Haar codec roundtrip: the depth-``levels`` orthogonal-average Haar
transform of a uint8 frame with deadzone-quantized details, and its
dequantizing inverse, as ``wicca_tpu``'s ``encode(wavelet='haar')`` and
``decode(emit_u8=True)`` define them:

* a level maps each 2x2 block ``[[a, b], [c, d]]`` to
  ``ll = (a+b+c+d)/4``, ``lh = (a-b+c-d)/4``, ``hl = (a+b-c-d)/4``,
  ``hh = (a-b-c+d)/4``, bands stored fine to coarse as ``(lh, hl, hh)``;
* codes are ``trunc(band / step)``, held in ``[-127, 127]`` (int8);
* the inverse dequantizes ``(q + 0.5 sign q) * step`` and undoes each
  level; the frame is clipped to ``[0, 255]`` and truncated to uint8.

In float64 every value here is exact for 8-bit frames at step 1 (at most
20 significant bits), so the result does not depend on the order of the
arithmetic. ``dtype`` picks a lower precision for the control.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class Roundtrip:
    ll: torch.Tensor  # coarse band, ``dtype``
    details: list  # [(lh, hl, hh)] fine to coarse, integer-valued ``dtype``
    recon: torch.Tensor  # uint8 reconstruction


def _interleave(a: torch.Tensor, b: torch.Tensor, axis: int) -> torch.Tensor:
    return torch.stack([a, b], dim=axis).flatten(axis - 1 if axis < 0 else axis, axis if axis < 0 else axis + 1)


def roundtrip(x: torch.Tensor, levels: int, step: float, dtype=torch.float64) -> Roundtrip:
    """``x``: planar ``(..., H, W)`` uint8 with H and W divisible by ``2**levels``."""
    if x.shape[-2] % (1 << levels) or x.shape[-1] % (1 << levels):
        raise ValueError("H and W must be divisible by 2**levels")
    v = x.to(dtype)
    details = []
    for _ in range(levels):
        rs = v[..., 0::2, :] + v[..., 1::2, :]
        rd = v[..., 0::2, :] - v[..., 1::2, :]
        lh = (rs[..., 0::2] - rs[..., 1::2]) / 4
        hl = (rd[..., 0::2] + rd[..., 1::2]) / 4
        hh = (rd[..., 0::2] - rd[..., 1::2]) / 4
        v = (rs[..., 0::2] + rs[..., 1::2]) / 4
        details.append(tuple(torch.trunc(b / step).clamp(-127, 127) for b in (lh, hl, hh)))
    ll = v
    for lh, hl, hh in reversed(details):
        u_lh, u_hl, u_hh = ((q + 0.5 * torch.sign(q)) * step for q in (lh, hl, hh))
        rs_e, rs_o = (v + u_lh) * 2, (v - u_lh) * 2
        rd_e, rd_o = (u_hl + u_hh) * 2, (u_hl - u_hh) * 2
        even = _interleave((rs_e + rd_e) / 2, (rs_o + rd_o) / 2, axis=-1)
        odd = _interleave((rs_e - rd_e) / 2, (rs_o - rd_o) / 2, axis=-1)
        v = _interleave(even, odd, axis=-2)
    recon = torch.trunc(v.clamp(0, 255)).to(torch.uint8)
    return Roundtrip(ll=ll, details=details, recon=recon)
