"""The float-lifting kernels and their plain PyTorch twins (counterpart of
``wicca_tpu/ops/dwt97_pallas.py``).

Each wrapper, its plain twin, and the TPU kernel it replaces:

* K8 :func:`dwt97_multilevel_quant` / :func:`dwt97_multilevel_quant_plain`
  — ``dwt97_multilevel_quant_pallas``;
* K9 :func:`idwt97_multilevel_dequant` /
  :func:`idwt97_multilevel_dequant_plain` —
  ``idwt97_multilevel_dequant_pallas``.

``filt`` is ``'cdf97'`` (CDF 9/7, the JPEG2000 irreversible filter; the
codec's ``bior4.4`` and ``cdf97``) or ``'db2'``. Tile semantics are those of
:mod:`wicca_tpu_torch.ops.dwt53_cuda`: independent (512, 1024) tiles, every
lifting step clamped at its tile's edges, the same grid for encode and
decode. The arithmetic is the Pallas kernel's, not
:mod:`wicca_tpu_torch.core.lifting`'s: constants rounded once to float32, a
scale by ``1/c`` as a product with ``f32(1/c)``, codes
``int16(trunc(clip(band * f32(1/step), -32767, 32767)))`` and
reconstruction ``(q + f32(offset) * sign q) * f32(step)``. Kernel and twin
agree bit for bit; the JAX reference, whose XLA build contracts some
products into fused multiply-adds, agrees within the tolerance stated in
``tests/test_torch_dwt97.py``.

With ``color='ict'`` the input of K8 is planar RGB or RGBA, and its first
launch applies the codec's forward ICT with ``chroma_gain``
(:func:`~wicca_tpu_torch.core.color.ict_fwd_codec`) before lifting; the
last launch of K9 applies its inverse
(:func:`~wicca_tpu_torch.core.color.ict_inv_codec`) and then, with
``emit_u8``, the clip to uint8. The plain twins are exactly that
composition.

A wrapper takes its plain twin only for a tensor on the CPU. For a CUDA
tensor it launches its kernel (``csrc/lifting_float_kernels.cu``, one launch
per level) or raises; nothing falls back. Each launch adds one to
:data:`LAUNCHES`; each wrapper call is the span ``ops.<wrapper>``.
"""

from __future__ import annotations

import torch

from wicca_tpu_torch.core.color import ict_fwd_codec, ict_inv_codec
from wicca_tpu_torch.core.haar import _interleave
from wicca_tpu_torch.core.lifting import (
    _A97,
    _B97,
    _D4_SCALE_D,
    _D4_SCALE_S,
    _D97,
    _G97,
    _K97,
    _SQ3,
    _rows,
    _shift,
    _split_pairs,
)
from wicca_tpu_torch.ops import _build
from wicca_tpu_torch.ops.dwt53_cuda import _coarse_grid, _tilewise, _unflatten
from wicca_tpu_torch.ops.dwt_cuda import (
    _TILE_H,
    _TILE_W,
    _band_steps3,
    _f32,
    _inv,
    _pad_dim_to,
    _planes,
    _quant_band,
    _require_cuda,
    _tiled_extent,
    _tiling,
    contiguous_aligned,
    launch_on_card,
)
from wicca_tpu_torch.utils.timing import spanned

# launches per wrapper since the last reset_launches()
LAUNCHES = {"dwt97_multilevel_quant": 0, "idwt97_multilevel_dequant": 0}

_FILTERS = {"cdf97": 0, "db2": 1}  # the kernels' filter ids
_COLORS = {"none": 0, "ict": 1}
_QMAX = 32767  # codes are always int16


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# plain lifting along the last axis, in the Pallas kernel's op order, with
# core/lifting.py's constants (Python doubles, rounded once to float32);
# _shift clamps each step's own signal, as _next/_prev do there
# ---------------------------------------------------------------------------


def _lift97(x):
    e, o = _split_pairs(x)
    d = o + _f32(_A97) * (e + _shift(e, 1))
    s = e + _f32(_B97) * (_shift(d, -1) + d)
    d = d + _f32(_G97) * (s + _shift(s, 1))
    s = s + _f32(_D97) * (_shift(d, -1) + d)
    return s * _f32(1.0 / _K97), d * _f32(_K97)


def _unlift97(s, d):
    s = s * _f32(_K97)
    d = d * _f32(1.0 / _K97)
    s = s - _f32(_D97) * (_shift(d, -1) + d)
    d = d - _f32(_G97) * (s + _shift(s, 1))
    s = s - _f32(_B97) * (_shift(d, -1) + d)
    o = d - _f32(_A97) * (s + _shift(s, 1))
    return _interleave(s, o, axis=-1)


def _lift_db2(x):
    e, o = _split_pairs(x)
    s1 = e + _f32(_SQ3) * o
    d1 = o - _f32(_SQ3 / 4.0) * s1 - _f32((_SQ3 - 2.0) / 4.0) * _shift(s1, -1)
    s2 = s1 - _shift(d1, 1)
    return s2 * _f32(_D4_SCALE_S), d1 * _f32(_D4_SCALE_D)


def _unlift_db2(s, d):
    s2 = s * _f32(1.0 / _D4_SCALE_S)
    d1 = d * _f32(1.0 / _D4_SCALE_D)
    s1 = s2 + _shift(d1, 1)
    o = d1 + _f32(_SQ3 / 4.0) * s1 + _f32((_SQ3 - 2.0) / 4.0) * _shift(s1, -1)
    e = s1 - _f32(_SQ3) * o
    return _interleave(e, o, axis=-1)


_ROW_LIFTS = {"cdf97": (_lift97, _unlift97), "db2": (_lift_db2, _unlift_db2)}


def _level_fwd(x, filt: str):
    """One 2-D level, horizontal then vertical: ``(ll, lh, hl, hh)``."""
    lift = _ROW_LIFTS[filt][0]
    lo, hi = lift(x)
    ll, hl = _rows(lift, lo)
    lh, hh = _rows(lift, hi)
    return ll, lh, hl, hh


def _level_inv(ll, lh, hl, hh, filt: str):
    unlift = _ROW_LIFTS[filt][1]
    return unlift(_rows(unlift, ll, hl), _rows(unlift, lh, hh))


# ---------------------------------------------------------------------------
# K8: forward + quantization
# ---------------------------------------------------------------------------


def _check_color(t: torch.Tensor, color: str, chroma_gain: float) -> None:
    if color not in _COLORS:
        raise ValueError(f"color must be one of {sorted(_COLORS)}, got {color!r}")
    if color == "ict" and (t.ndim < 3 or t.shape[-3] not in (3, 4)):
        raise ValueError(f"color='ict' needs planar (..., 3|4, H, W) planes, got {tuple(t.shape)}")
    if not chroma_gain > 0:
        raise ValueError(f"chroma_gain must be > 0, got {chroma_gain}")


def _check_fwd(x: torch.Tensor, steps: tuple, filt: str, color: str = "none", chroma_gain: float = 1.0) -> int:
    if filt not in _FILTERS:
        raise ValueError(f"filt must be one of {sorted(_FILTERS)}")
    _check_color(x, color, chroma_gain)
    k = len(steps)
    if not 1 <= k <= 3:
        raise ValueError("1..3 levels per pass")
    if x.ndim < 2 or x.numel() == 0:
        raise ValueError(f"dwt97_multilevel_quant wants a non-empty (..., H, W) tensor, got {tuple(x.shape)}")
    unit = 1 << k
    if x.shape[-2] % unit or x.shape[-1] % unit:
        raise ValueError(f"H, W must be divisible by {unit}")
    return k


def _as_input(x: torch.Tensor) -> torch.Tensor:
    """uint8 stays uint8 (widened exactly in the kernel); any other dtype is
    cast to float32, as the reference does."""
    return x if x.dtype in (torch.uint8, torch.float32) else x.to(torch.float32)


def dwt97_multilevel_quant_plain(x: torch.Tensor, steps: tuple, filt: str = "cdf97", color: str = "none",
                                 chroma_gain: float = 1.0):
    """``k = len(steps)`` <= 3 tile-local float lifting levels of planar
    ``(..., H, W)`` input (uint8 or any dtype cast to float32), H and W
    divisible by ``2**k``, each level horizontal then vertical, with the
    detail bands quantized to int16 by their (lh, hl, hh) steps. Returns
    ``(ll_f32, [(lh, hl, hh) int16, ...])`` fine to coarse, over the input
    edge-padded to tile multiples. ``color='ict'``: the codec's forward ICT
    with ``chroma_gain`` first (RGB or RGBA planes on the third axis from
    last)."""
    _check_fwd(x, steps, filt, color, chroma_gain)
    if color == "ict":
        x = ict_fwd_codec(x, chroma_gain)
    steps = _band_steps3(steps)
    lead = tuple(x.shape[:-2])
    flat = x.reshape(-1, x.shape[-2], x.shape[-1])
    cur, th, tw = _tiling(flat.to(torch.float32))  # exact from uint8
    details = []
    for level_steps in steps:
        cur, *bands = _tilewise(lambda t: _level_fwd(t, filt), cur, th, tw)
        details.append(tuple(_quant_band(b, s, _QMAX, torch.int16) for b, s in zip(bands, level_steps)))
        th, tw = th // 2, tw // 2
    return _unflatten(lead, cur, details)


def _launch_fwd(lib, x: torch.Tensor, steps: tuple, filt: str, stream: int, color: str = "none",
                chroma_gain: float = 1.0):
    """K8's launches through ``lib`` on ``stream`` (``x`` uint8 or float32,
    checked; ``steps`` in (lh, hl, hh) triples): one per level, the LL of
    each level the next one's input; the first applies ``color``."""
    c, h, w = _planes(x.shape), x.shape[-2], x.shape[-1]
    cin = x.shape[-3] if color == "ict" else 1
    hp, th = _tiled_extent(h, _TILE_H)
    wp, tw = _tiled_extent(w, _TILE_W)
    cur, details = x, []
    for lvl, level_steps in enumerate(steps, start=1):
        hb, wb = hp >> lvl, wp >> lvl
        ll = torch.empty((c, hb, wb), dtype=torch.float32, device=x.device)
        bands = tuple(torch.empty((c, hb, wb), dtype=torch.int16, device=x.device) for _ in range(3))
        rc = lib.wicca_lift97_fwd_level(cur.data_ptr(), int(cur.dtype == torch.uint8), _FILTERS[filt], c,
                                        cur.shape[-2], cur.shape[-1], hb, wb, th >> lvl, tw >> lvl, ll.data_ptr(),
                                        *(b.data_ptr() for b in bands), *(_inv(s) for s in level_steps),
                                        _COLORS[color] if lvl == 1 else 0, cin, _inv(chroma_gain), stream)
        _build.check(rc, "dwt97_multilevel_quant")
        LAUNCHES["dwt97_multilevel_quant"] += 1
        details.append(bands)
        cur = ll
    return _unflatten(tuple(x.shape[:-2]), cur, details)


@spanned("ops.dwt97_multilevel_quant")
def dwt97_multilevel_quant(x: torch.Tensor, steps: tuple, filt: str = "cdf97", color: str = "none",
                           chroma_gain: float = 1.0):
    """K8: :func:`dwt97_multilevel_quant_plain` as one launch per level; the
    tile padding of the input is an index clamp in the kernel, and the ICT
    (``color='ict'``) the first launch's prologue."""
    _check_fwd(x, steps, filt, color, chroma_gain)
    if x.device.type == "cpu":
        return dwt97_multilevel_quant_plain(x, steps, filt, color, chroma_gain)
    x = contiguous_aligned(_as_input(x))
    _require_cuda("dwt97_multilevel_quant", x)
    return launch_on_card(x.get_device(), _launch_fwd, x, _band_steps3(steps), filt, color=color,
                          chroma_gain=chroma_gain)


# ---------------------------------------------------------------------------
# K9: dequantization + inverse
# ---------------------------------------------------------------------------


def _check_inv(ll: torch.Tensor, details, steps: tuple, orig_k: int, filt: str, color: str = "none",
               chroma_gain: float = 1.0) -> int:
    if filt not in _FILTERS:
        raise ValueError(f"filt must be one of {sorted(_FILTERS)}")
    _check_color(ll, color, chroma_gain)
    k = len(steps)
    if not 1 <= k <= 3 or len(details) != k:
        raise ValueError("1..3 levels per pass; details must match steps")
    if orig_k < k:
        raise ValueError("orig_k must be >= k")
    if ll.ndim < 2 or ll.numel() == 0:
        raise ValueError(f"ll must be a non-empty (..., h, w) tensor, got {tuple(ll.shape)}")
    for bands in details:
        if len(bands) != 3 or any(b.shape != bands[0].shape or b.dtype != torch.int16 for b in bands):
            raise ValueError("each level needs int16 (lh, hl, hh) codes of one shape")
        if bands[0].shape[:-2] != ll.shape[:-2]:
            raise ValueError(f"bands lead {tuple(bands[0].shape[:-2])} != ll lead {tuple(ll.shape[:-2])}")
    return k


def _dequantize(q: torch.Tensor, step: float, offset: float) -> torch.Tensor:
    qf = q.to(torch.float32)
    return (qf + torch.sign(qf) * _f32(offset)) * _f32(step)


def idwt97_multilevel_dequant_plain(ll: torch.Tensor, details, steps: tuple, emit_u8: bool = False,
                                    orig_k: int | None = None, filt: str = "cdf97", recon_offset: float = 0.5,
                                    color: str = "none", chroma_gain: float = 1.0) -> torch.Tensor:
    """Dequantize and invert :func:`dwt97_multilevel_quant_plain` on the
    same tile grid. ``details`` is ``[(lh, hl, hh), ...]`` fine to coarse,
    ``len(details) == len(steps)``. The LL is edge-padded to the coarse grid
    and each band edge-padded or cropped to its level's grid. For a partial
    pass of a progressive decode, ``orig_k`` is the depth of the encoder's
    pass, whose tiles set the clamps. ``color='ict'``: the codec's inverse
    ICT with ``chroma_gain`` last. float32 out, or uint8 (clip, truncate)
    with ``emit_u8``."""
    orig_k = len(steps) if orig_k is None else orig_k
    k = _check_inv(ll, details, steps, orig_k, filt, color, chroma_gain)
    steps = _band_steps3(steps)
    lead, (ch, cw) = tuple(ll.shape[:-2]), ll.shape[-2:]
    chp, cwp, th_c, tw_c = _coarse_grid(ch, cw, orig_k)
    x = _pad_dim_to(_pad_dim_to(ll.reshape(-1, ch, cw).to(torch.float32), -2, chp), -1, cwp)
    for lvl in range(k, 0, -1):
        m = 1 << (k - lvl)
        bands = [_pad_dim_to(_pad_dim_to(_dequantize(b.reshape(x.shape[0], *b.shape[-2:]), s, recon_offset),
                                         -2, chp * m), -1, cwp * m)[:, : chp * m, : cwp * m]
                 for b, s in zip(details[lvl - 1], steps[lvl - 1])]
        x = _tilewise(lambda *t: _level_inv(*t, filt), x, th_c * m, tw_c * m, *bands)
    x = x.reshape(lead + x.shape[-2:])
    if color == "ict":  # then the codec's _emit_native
        x = ict_inv_codec(x, chroma_gain)
        return torch.clamp(x, 0, 255).to(torch.uint8) if emit_u8 else x
    if emit_u8:
        x = torch.clamp(x, 0, 255).to(torch.int32).to(torch.uint8)
    return x


def _launch_inv(lib, ll: torch.Tensor, details, steps: tuple, emit_u8: bool, orig_k: int, filt: str,
                recon_offset: float, stream: int, color: str = "none", chroma_gain: float = 1.0) -> torch.Tensor:
    """K9's launches through ``lib`` on ``stream`` (``ll`` float32, codes
    int16, checked; ``steps`` in (lh, hl, hh) triples): one per level,
    coarse to fine; the last applies ``color`` and ``emit_u8``."""
    k = len(steps)
    cin = ll.shape[-3] if color == "ict" else 1
    c, ch, cw = _planes(ll.shape), ll.shape[-2], ll.shape[-1]
    chp, cwp, th_c, tw_c = _coarse_grid(ch, cw, orig_k)
    cur = ll
    for lvl in range(k, 0, -1):
        m = 1 << (k - lvl)
        hb, wb = chp * m, cwp * m
        lh, hl, hh = details[lvl - 1]
        u8 = emit_u8 and lvl == 1
        out = torch.empty((c, 2 * hb, 2 * wb), dtype=torch.uint8 if u8 else torch.float32, device=ll.device)
        rc = lib.wicca_lift97_inv_level(cur.data_ptr(), cur.shape[-2], cur.shape[-1], lh.data_ptr(), hl.data_ptr(),
                                        hh.data_ptr(), lh.shape[-2], lh.shape[-1], _FILTERS[filt], c, hb, wb,
                                        th_c * m, tw_c * m, *(_f32(s) for s in steps[lvl - 1]),
                                        _f32(recon_offset), out.data_ptr(), int(u8),
                                        _COLORS[color] if lvl == 1 else 0, cin, _f32(chroma_gain), stream)
        _build.check(rc, "idwt97_multilevel_dequant")
        LAUNCHES["idwt97_multilevel_dequant"] += 1
        cur = out
    return cur.reshape(tuple(ll.shape[:-2]) + cur.shape[-2:])


@spanned("ops.idwt97_multilevel_dequant")
def idwt97_multilevel_dequant(ll: torch.Tensor, details, steps: tuple, emit_u8: bool = False,
                              orig_k: int | None = None, filt: str = "cdf97", recon_offset: float = 0.5,
                              color: str = "none", chroma_gain: float = 1.0) -> torch.Tensor:
    """K9: :func:`idwt97_multilevel_dequant_plain` as one launch per level;
    the dequantization is the kernel's prologue, the padding and cropping of
    the LL and the bands are index clamps in it, and the inverse ICT
    (``color='ict'``) and the uint8 emit the last launch's epilogue."""
    orig_k = len(steps) if orig_k is None else orig_k
    _check_inv(ll, details, steps, orig_k, filt, color, chroma_gain)
    if ll.device.type == "cpu":
        return idwt97_multilevel_dequant_plain(ll, details, steps, emit_u8, orig_k, filt, recon_offset, color,
                                               chroma_gain)
    ll = contiguous_aligned(ll.to(torch.float32))
    details = [tuple(contiguous_aligned(b) for b in bands) for bands in details]
    _require_cuda("idwt97_multilevel_dequant", ll, *(b for bands in details for b in bands))
    return launch_on_card(ll.get_device(), _launch_inv, ll, details, _band_steps3(steps), emit_u8, orig_k, filt,
                          recon_offset, color=color, chroma_gain=chroma_gain)
