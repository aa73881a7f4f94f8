"""Multi-level 2-D Haar DWT / IDWT and the LL icon — plain PyTorch
(counterpart of ``wicca_tpu/core/haar.py``).

Numerical contract, the same as the JAX package's: for uint8 input cast to
float32, every LL element at every level is

    LL[i,j] = ((a + c) + (b + d)) * 0.25        (float32, fixed association)

where (a, c) and (b, d) are the vertical pairs of the 2x2 block: row pairs
are summed first, then column pairs, then scaled. Each step below is its
own PyTorch op, so nothing reassociates or contracts. The icon is
``clip(0, 255)`` then truncation to uint8.

The level transform (image normalization, lowpass DC gain 1):

    rs = e_r + o_r ; rd = e_r - o_r            (row pairs)
    LL = (rs_e + rs_o) * 0.25   LH = (rs_e - rs_o) * 0.25
    HL = (rd_e + rd_o) * 0.25   HH = (rd_e - rd_o) * 0.25

All functions work on the trailing two axes of ``(..., H, W)`` tensors.
"""

from __future__ import annotations

import dataclasses

import torch

from wicca_tpu_torch.core.pad import pad_to_multiple, unpad


@dataclasses.dataclass(frozen=True)
class Pyramid:
    """A multi-level decomposition: ``details[k]`` is the ``(lh, hl, hh)``
    triple of level ``k+1`` (finest first), ``ll`` the coarsest band and
    ``orig_shape`` the spatial dims before padding."""

    ll: torch.Tensor
    details: tuple[tuple[torch.Tensor, torch.Tensor, torch.Tensor], ...]
    wavelet: str = "haar"
    orig_shape: tuple[int, int] | None = None

    @property
    def levels(self) -> int:
        return len(self.details)


def _interleave(a: torch.Tensor, b: torch.Tensor, axis: int) -> torch.Tensor:
    """Merge even/odd halves along ``axis`` (-1 or -2)."""
    if axis == -1:
        return torch.stack([a, b], dim=-1).reshape(*a.shape[:-1], a.shape[-1] * 2)
    return torch.stack([a, b], dim=-2).reshape(*a.shape[:-2], a.shape[-2] * 2, a.shape[-1])


def dwt2_level(x: torch.Tensor):
    """One Haar level; returns ``(ll, lh, hl, hh)`` with trailing dims (H/2, W/2)."""
    e_r, o_r = x[..., 0::2, :], x[..., 1::2, :]
    rs = e_r + o_r
    rd = e_r - o_r
    rs_e, rs_o = rs[..., 0::2], rs[..., 1::2]
    rd_e, rd_o = rd[..., 0::2], rd[..., 1::2]
    ll = (rs_e + rs_o) * 0.25
    lh = (rs_e - rs_o) * 0.25
    hl = (rd_e + rd_o) * 0.25
    hh = (rd_e - rd_o) * 0.25
    return ll, lh, hl, hh


def idwt2_level(ll, lh, hl, hh) -> torch.Tensor:
    """Exact inverse of :func:`dwt2_level` (all scalings are powers of two)."""
    rs_e = (ll + lh) * 2.0
    rs_o = (ll - lh) * 2.0
    rd_e = (hl + hh) * 2.0
    rd_o = (hl - hh) * 2.0
    rs = _interleave(rs_e, rs_o, axis=-1)
    rd = _interleave(rd_e, rd_o, axis=-1)
    e_r = (rs + rd) * 0.5
    o_r = (rs - rd) * 0.5
    return _interleave(e_r, o_r, axis=-2)


def dwt2(x: torch.Tensor, levels: int, mode="replicate", constant=0) -> Pyramid:
    """Multi-level decomposition of ``(..., H, W)`` data: pad bottom/right
    to a multiple of ``2**levels``, cast to float32, recurse on LL."""
    if levels < 1:
        raise ValueError("levels must be >= 1")
    orig = (x.shape[-2], x.shape[-1])
    ll = pad_to_multiple(x, 2**levels, mode=mode, constant=constant).to(torch.float32)
    details = []
    for _ in range(levels):
        ll, lh, hl, hh = dwt2_level(ll)
        details.append((lh, hl, hh))
    return Pyramid(ll=ll, details=tuple(details), wavelet="haar", orig_shape=orig)


def idwt2(pyr: Pyramid) -> torch.Tensor:
    """Full inverse, cropped to the original dims."""
    x = pyr.ll
    for lh, hl, hh in reversed(pyr.details):
        x = idwt2_level(x, lh, hl, hh)
    if pyr.orig_shape is not None:
        x = unpad(x, *pyr.orig_shape)
    return x


def block_mean_ll(x: torch.Tensor, depth: int) -> torch.Tensor:
    """LL-only chain on float32 ``x`` whose trailing dims divide by ``2**depth``."""
    ll = x
    for _ in range(depth):
        rs = ll[..., 0::2, :] + ll[..., 1::2, :]
        ll = (rs[..., 0::2] + rs[..., 1::2]) * 0.25
    return ll


def haar_icon(image: torch.Tensor, depth: int, mode="replicate", constant=0) -> torch.Tensor:
    """Reference-parity icon of planar ``(..., H, W)`` input: pad, float32
    block-mean chain, clip, uint8."""
    x = pad_to_multiple(image, 2**depth, mode=mode, constant=constant).to(torch.float32)
    return torch.clamp(block_mean_ll(x, depth), 0, 255).to(torch.uint8)
