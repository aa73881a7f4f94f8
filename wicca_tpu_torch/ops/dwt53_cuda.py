"""The lossless lifting kernels and their plain PyTorch twins (counterpart of
``wicca_tpu/ops/dwt53_pallas.py``).

Each wrapper, its plain twin, and the TPU kernel it replaces:

* K6 :func:`dwt53_multilevel` / :func:`dwt53_multilevel_plain` —
  ``dwt53_multilevel_pallas``;
* K7 :func:`idwt53_multilevel` / :func:`idwt53_multilevel_plain` —
  ``idwt53_multilevel_pallas``.

Tile semantics are JPEG2000's independent tiles: a pass's input is cut into
(512, 1024) tiles (one tile per dimension that fits), each level of the
pass works on the tile halved per level, and every lifting step clamps at
that tile's edges. Encode and decode use the same grid, so the roundtrip is
exact. ``filt`` is ``'legall5.3'`` (the JPEG2000 reversible 5/3) or
``'haar_int'`` (the S-transform; pair-local, so the tiles are invisible).

With ``color='rct'`` the input of K6 is planar RGB or RGBA, and its first
launch applies the reversible color transform
(:func:`~wicca_tpu_torch.core.color.rct_fwd_codec`) before lifting; the
last launch of K7 applies its inverse
(:func:`~wicca_tpu_torch.core.color.rct_inv_codec`) and then, with
``emit_u8``, the clip to uint8. The plain twins are exactly that
composition.

A wrapper takes its plain twin only for a tensor on the CPU. For a CUDA
tensor it launches its kernel (``csrc/lifting_kernels.cu``, one launch per
level) or raises; nothing falls back. Each launch adds one to
:data:`LAUNCHES`; each wrapper call is the span ``ops.<wrapper>``.
"""

from __future__ import annotations

import torch

from wicca_tpu_torch.core.color import rct_fwd_codec, rct_inv_codec
from wicca_tpu_torch.core.lifting import dwt2_level_lifting, idwt2_level_lifting
from wicca_tpu_torch.ops import _build
from wicca_tpu_torch.ops.dwt_cuda import (
    _TILE_H,
    _TILE_W,
    _pad_dim_to,
    _planes,
    _require_cuda,
    _tiled_extent,
    _tiling,
    contiguous_aligned,
    launch_on_card,
)
from wicca_tpu_torch.utils.timing import spanned

# launches per wrapper since the last reset_launches()
LAUNCHES = {"dwt53_multilevel": 0, "idwt53_multilevel": 0}

_FILTERS = {"legall5.3": 0, "haar_int": 1}  # the kernels' filter ids
_COLORS = {"none": 0, "rct": 1}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _tilewise(fn, x: torch.Tensor, th: int, tw: int, *more: torch.Tensor):
    """Apply a 2-D function of the trailing axes to every (th, tw) tile of
    ``(c, H, W)`` tensors independently; outputs are stitched back. Every
    output of ``fn`` keeps its tile's place, scaled as its extent is."""
    c, h, w = x.shape
    ty, tx = h // th, w // tw

    def tiles(a, sh, sw):
        return a.reshape(c, ty, sh, tx, sw).permute(0, 1, 3, 2, 4)

    out = fn(tiles(x, th, tw), *(tiles(m, th, tw) for m in more))
    outs = out if isinstance(out, tuple) else (out,)
    stitched = tuple(o.permute(0, 1, 3, 2, 4).reshape(c, ty * o.shape[-2], tx * o.shape[-1]) for o in outs)
    return stitched if isinstance(out, tuple) else stitched[0]


# ---------------------------------------------------------------------------
# K6: forward
# ---------------------------------------------------------------------------


def _check_color(t: torch.Tensor, color: str) -> None:
    if color not in _COLORS:
        raise ValueError(f"color must be one of {sorted(_COLORS)}, got {color!r}")
    if color == "rct" and (t.ndim < 3 or t.shape[-3] not in (3, 4)):
        raise ValueError(f"color='rct' needs planar (..., 3|4, H, W) planes, got {tuple(t.shape)}")


# a unit of K6/K7 reads its rows at 32-bit offsets from a 64-bit base, and
# even a one-pair-row chunk spans 5 rows (csrc/lifting_kernels.cu, plan())
_MAX_ROW = ((1 << 31) - 1) // 5


def _check_rows(name: str, *widths: int) -> None:
    if max(widths) > _MAX_ROW:
        raise ValueError(f"{name}: rows of {max(widths)} samples; the kernels take at most {_MAX_ROW}")


def _check_fwd(x: torch.Tensor, k: int, filt: str, color: str = "none") -> None:
    if filt not in _FILTERS:
        raise ValueError(f"filt must be one of {sorted(_FILTERS)}")
    _check_color(x, color)
    if not 1 <= k <= 3:
        raise ValueError("1..3 levels per pass")
    if x.ndim < 2 or x.numel() == 0:
        raise ValueError(f"dwt53_multilevel wants a non-empty (..., H, W) tensor, got {tuple(x.shape)}")
    unit = 1 << k
    if x.shape[-2] % unit or x.shape[-1] % unit:
        raise ValueError(f"H, W must be divisible by {unit}")


def _as_input(x: torch.Tensor) -> torch.Tensor:
    """uint8 stays uint8; any other dtype is cast to int32, as the reference does."""
    return x if x.dtype in (torch.uint8, torch.int32) else x.to(torch.int32)


def _unflatten(lead: tuple, ll: torch.Tensor, details):
    return (ll.reshape(lead + ll.shape[-2:]),
            [tuple(b.reshape(lead + b.shape[-2:]) for b in bands) for bands in details])


def dwt53_multilevel_plain(x: torch.Tensor, k: int, filt: str = "legall5.3", color: str = "none"):
    """``k`` <= 3 tile-local reversible levels of planar ``(..., H, W)``
    uint8 or int32 input, H and W divisible by ``2**k``, each level
    horizontal then vertical (:func:`~wicca_tpu_torch.core.lifting.dwt2_level_lifting`
    on every tile). Returns ``(ll_i32, [(lh, hl, hh) int16, ...])`` fine to
    coarse, over the input edge-padded to tile multiples. ``color='rct'``:
    the codec's forward RCT first (RGB or RGBA planes on the third axis from
    last)."""
    _check_fwd(x, k, filt, color)
    if color == "rct":
        x = rct_fwd_codec(x)
    lead = tuple(x.shape[:-2])
    cur, th, tw = _tiling(x.reshape(-1, x.shape[-2], x.shape[-1]).to(torch.int32))
    details = []
    for _ in range(k):
        cur, *bands = _tilewise(lambda t: dwt2_level_lifting(t, filt), cur, th, tw)
        details.append(tuple(b.to(torch.int16) for b in bands))
        th, tw = th // 2, tw // 2
    return _unflatten(lead, cur, details)


def _launch_fwd(lib, x: torch.Tensor, k: int, filt: str, stream: int, color: str = "none"):
    """K6's launches through ``lib`` on ``stream`` (``x`` uint8 or int32,
    checked): one per level, the LL of each level the next one's input; the
    first applies ``color``."""
    c, h, w = _planes(x.shape), x.shape[-2], x.shape[-1]
    cin = x.shape[-3] if color == "rct" else 1
    hp, th = _tiled_extent(h, _TILE_H)
    wp, tw = _tiled_extent(w, _TILE_W)
    _check_rows("dwt53_multilevel", w)
    cur, details = x, []
    for lvl in range(1, k + 1):
        hb, wb = hp >> lvl, wp >> lvl
        ll = torch.empty((c, hb, wb), dtype=torch.int32, device=x.device)
        bands = tuple(torch.empty((c, hb, wb), dtype=torch.int16, device=x.device) for _ in range(3))
        rc = lib.wicca_lift_fwd_level(cur.data_ptr(), int(cur.dtype == torch.uint8), _FILTERS[filt], c,
                                      cur.shape[-2], cur.shape[-1], hb, wb, th >> lvl, tw >> lvl, ll.data_ptr(),
                                      *(b.data_ptr() for b in bands), _COLORS[color] if lvl == 1 else 0, cin,
                                      stream)
        _build.check(rc, "dwt53_multilevel")
        LAUNCHES["dwt53_multilevel"] += 1
        details.append(bands)
        cur = ll
    return _unflatten(tuple(x.shape[:-2]), cur, details)


@spanned("ops.dwt53_multilevel")
def dwt53_multilevel(x: torch.Tensor, k: int, filt: str = "legall5.3", color: str = "none"):
    """K6: :func:`dwt53_multilevel_plain` as one launch per level; the tile
    padding of the input is an index clamp in the kernel, and the RCT
    (``color='rct'``) the first launch's prologue."""
    _check_fwd(x, k, filt, color)
    if x.device.type == "cpu":
        return dwt53_multilevel_plain(x, k, filt, color)
    x = contiguous_aligned(_as_input(x))
    _require_cuda("dwt53_multilevel", x)
    return launch_on_card(x.get_device(), _launch_fwd, x, k, filt, color=color)


# ---------------------------------------------------------------------------
# K7: inverse
# ---------------------------------------------------------------------------


def _check_inv(ll: torch.Tensor, details, k: int, orig_k: int, filt: str, color: str = "none") -> None:
    if filt not in _FILTERS:
        raise ValueError(f"filt must be one of {sorted(_FILTERS)}")
    _check_color(ll, color)
    if not 1 <= k <= 3 or len(details) != k:
        raise ValueError("1..3 levels per pass; details must match k")
    if orig_k < k:
        raise ValueError("orig_k must be >= k")
    if ll.ndim < 2 or ll.numel() == 0:
        raise ValueError(f"ll must be a non-empty (..., h, w) tensor, got {tuple(ll.shape)}")
    for bands in details:
        if len(bands) != 3 or any(b.shape != bands[0].shape or b.dtype != torch.int16 for b in bands):
            raise ValueError("each level needs int16 (lh, hl, hh) of one shape")
        if bands[0].shape[:-2] != ll.shape[:-2]:
            raise ValueError(f"bands lead {tuple(bands[0].shape[:-2])} != ll lead {tuple(ll.shape[:-2])}")


def _coarse_grid(ch: int, cw: int, orig_k: int) -> tuple[int, int, int, int]:
    """(chp, cwp, th_c, tw_c): the coarse tile is the encoder's tile divided
    by the full pass depth, and the LL grid a multiple of it."""
    th_c, tw_c = min(ch, _TILE_H >> orig_k), min(cw, _TILE_W >> orig_k)
    return -(-ch // th_c) * th_c, -(-cw // tw_c) * tw_c, th_c, tw_c


def idwt53_multilevel_plain(ll: torch.Tensor, details, k: int, emit_u8: bool = False, orig_k: int | None = None,
                            filt: str = "legall5.3", color: str = "none") -> torch.Tensor:
    """Exact inverse of :func:`dwt53_multilevel_plain` on the same tile
    grid. ``details`` is ``[(lh, hl, hh), ...]`` fine to coarse,
    ``len(details) == k``. The LL is edge-padded to the coarse grid and each
    band edge-padded or cropped to its level's grid. For a partial pass of a
    progressive decode, ``orig_k`` is the depth of the encoder's pass, whose
    tiles set the clamps. ``color='rct'``: the codec's inverse RCT last.
    int32 out, or uint8 (clip, cast) with ``emit_u8``."""
    orig_k = k if orig_k is None else orig_k
    _check_inv(ll, details, k, orig_k, filt, color)
    lead, (ch, cw) = tuple(ll.shape[:-2]), ll.shape[-2:]
    chp, cwp, th_c, tw_c = _coarse_grid(ch, cw, orig_k)
    x = _pad_dim_to(_pad_dim_to(ll.reshape(-1, ch, cw).to(torch.int32), -2, chp), -1, cwp)
    for lvl in range(k, 0, -1):
        m = 1 << (k - lvl)
        bands = [_pad_dim_to(_pad_dim_to(b.reshape(x.shape[0], *b.shape[-2:]).to(torch.int32), -2, chp * m),
                             -1, cwp * m)[:, : chp * m, : cwp * m] for b in details[lvl - 1]]
        x = _tilewise(lambda *t: idwt2_level_lifting(*t, filt), x, th_c * m, tw_c * m, *bands)
    x = x.reshape(lead + x.shape[-2:])
    if color == "rct":  # then the codec's _emit_native
        x = rct_inv_codec(x)
    if emit_u8:
        x = torch.clamp(x, 0, 255).to(torch.uint8)
    return x


def _launch_inv(lib, ll: torch.Tensor, details, k: int, emit_u8: bool, orig_k: int, filt: str,
                stream: int, color: str = "none") -> torch.Tensor:
    """K7's launches through ``lib`` on ``stream`` (``ll`` int32, bands
    int16, checked): one per level, coarse to fine; the last applies
    ``color`` and ``emit_u8``."""
    c, ch, cw = _planes(ll.shape), ll.shape[-2], ll.shape[-1]
    cin = ll.shape[-3] if color == "rct" else 1
    chp, cwp, th_c, tw_c = _coarse_grid(ch, cw, orig_k)
    _check_rows("idwt53_multilevel", cwp << (k - 1), *(bands[0].shape[-1] for bands in details))
    cur = ll
    for lvl in range(k, 0, -1):
        m = 1 << (k - lvl)
        hb, wb = chp * m, cwp * m
        lh, hl, hh = details[lvl - 1]
        u8 = emit_u8 and lvl == 1
        out = torch.empty((c, 2 * hb, 2 * wb), dtype=torch.uint8 if u8 else torch.int32, device=ll.device)
        rc = lib.wicca_lift_inv_level(cur.data_ptr(), cur.shape[-2], cur.shape[-1], lh.data_ptr(), hl.data_ptr(),
                                      hh.data_ptr(), lh.shape[-2], lh.shape[-1],
                                      _FILTERS[filt], c, hb, wb, th_c * m, tw_c * m, out.data_ptr(), int(u8),
                                      _COLORS[color] if lvl == 1 else 0, cin, stream)
        _build.check(rc, "idwt53_multilevel")
        LAUNCHES["idwt53_multilevel"] += 1
        cur = out
    return cur.reshape(tuple(ll.shape[:-2]) + cur.shape[-2:])


@spanned("ops.idwt53_multilevel")
def idwt53_multilevel(ll: torch.Tensor, details, k: int, emit_u8: bool = False, orig_k: int | None = None,
                      filt: str = "legall5.3", color: str = "none") -> torch.Tensor:
    """K7: :func:`idwt53_multilevel_plain` as one launch per level; the
    padding and cropping of the LL and the bands are index clamps in the
    kernel, and the inverse RCT (``color='rct'``) and the uint8 emit the
    last launch's epilogue."""
    orig_k = k if orig_k is None else orig_k
    _check_inv(ll, details, k, orig_k, filt, color)
    if ll.device.type == "cpu":
        return idwt53_multilevel_plain(ll, details, k, emit_u8, orig_k, filt, color)
    ll = contiguous_aligned(ll.to(torch.int32))
    details = [tuple(contiguous_aligned(b) for b in bands) for bands in details]
    _require_cuda("idwt53_multilevel", ll, *(b for bands in details for b in bands))
    return launch_on_card(ll.get_device(), _launch_inv, ll, details, k, emit_u8, orig_k, filt, color=color)
