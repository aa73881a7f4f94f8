"""The Haar kernels and their plain PyTorch twins (counterpart of
``wicca_tpu/ops/dwt_pallas.py``).

Each wrapper, its plain twin, and the TPU kernel it replaces
(``wicca_tpu/ops/dwt_pallas.py``):

* K1 :func:`icon` / :func:`icon_plain` — ``icon_pallas``;
* K2 :func:`dwt_multilevel_quant` / :func:`dwt_multilevel_quant_plain` —
  ``dwt_multilevel_quant_pallas``;
* K3 :func:`idwt_multilevel_dequant` / :func:`idwt_multilevel_dequant_plain`
  — ``idwt_multilevel_dequant_pallas``;
* K4 :func:`dwt_level_quant` / :func:`dwt_level_quant_plain` —
  ``dwt_level_quant_pallas``;
* K5 :func:`idwt_level_dequant` / :func:`idwt_level_dequant_plain` —
  ``idwt_level_dequant_pallas``.

A wrapper takes its plain twin only for a tensor on the CPU. For a CUDA
tensor it launches its kernel (``csrc/haar_kernels.cu``) or raises; nothing
falls back. Each launch adds one to :data:`LAUNCHES`; each wrapper call is
the span ``ops.<wrapper>`` (:mod:`wicca_tpu_torch.utils.timing`).

K2's and K3's launches are :class:`DwtPass` and :class:`IdwtPass`: one
pass of a fixed geometry with its launch arguments packed once, holding no
tensor. The wrappers build one per call; the codec's launch plans
(:mod:`wicca_tpu_torch.codec.pipeline`) keep them per geometry and launch
them through :func:`launch_on_card`, without the wrappers' checks and
spans, counting each launch in :data:`LAUNCHES` all the same.

K1-K3 work on semantic extents: for the pair-local Haar transform the JAX
kernels' (512, 1024) tile padding never reaches a stored stream (the codec
crops it away). K4 and K5 are public ops whose output shapes show that
padding, so they reproduce it (:func:`_tiling`), as do the lifting kernels
K6/K7 (:mod:`wicca_tpu_torch.ops.dwt53_cuda`), where the tiles also fix the
lifting clamps.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from wicca_tpu_torch.core.haar import _interleave, idwt2_level
from wicca_tpu_torch.ops import _build
from wicca_tpu_torch.utils.timing import spanned

# launches per wrapper since the last reset_launches()
LAUNCHES = {"icon": 0, "dwt_multilevel_quant": 0, "idwt_multilevel_dequant": 0, "dwt_level_quant": 0,
            "idwt_level_dequant": 0}

_EXACT_ICON_LEVELS = 6  # int32 sums of 4**6 uint8 pixels stay below 2**24

# The reference's tile caps: a dimension above its cap is edge-padded to a
# multiple of it, which fixes the band shapes K4/K5 return and, for the
# lifting kernels, where every level clamps.
_TILE_H = 512
_TILE_W = 1024


def _pad_dim_to(x: torch.Tensor, axis: int, mult: int) -> torch.Tensor:
    """Edge-replicate one trailing axis up to a multiple of ``mult``."""
    size = x.shape[axis]
    extra = -size % mult
    if extra == 0:
        return x
    idx = torch.clamp(torch.arange(size + extra, device=x.device), max=size - 1)
    return x.index_select(axis, idx)


def _tiled_extent(n: int, cap: int) -> tuple[int, int]:
    """(padded extent, tile) of one dimension: one tile when ``n`` fits the
    cap, else tiles of ``cap`` over ``n`` rounded up to a multiple of it."""
    return (-(-n // cap) * cap, cap) if n > cap else (n, n)


def _tiling(x: torch.Tensor) -> tuple[torch.Tensor, int, int]:
    """``x`` edge-padded to tile multiples, and the tile ``(th, tw)``."""
    _, th = _tiled_extent(x.shape[-2], _TILE_H)
    _, tw = _tiled_extent(x.shape[-1], _TILE_W)
    return _pad_dim_to(_pad_dim_to(x, -2, th), -1, tw), th, tw


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _detail_dtype(step: float):
    """int8 iff floor(max|band| / step) fits (image-normalized bands <= 127.5)."""
    return (torch.int8, 127) if 127.5 / step < 128.0 else (torch.int16, 32767)


def _band_steps3(steps: tuple) -> tuple:
    """Normalize per-level step entries to (lh, hl, hh) triples: a scalar
    entry applies to all three bands; a 3-tuple entry is used as-is."""
    return tuple(
        tuple(s) if isinstance(s, (tuple, list)) else (float(s),) * 3 for s in steps
    )


@functools.lru_cache(maxsize=256)
def _f32(v: float) -> float:
    """``v`` rounded to float32, held exactly in a Python float."""
    return float(np.float32(v))


@functools.lru_cache(maxsize=256)
def _inv(step: float) -> float:
    """The quantizer's multiplier: 1/step in float64, rounded once to float32."""
    return _f32(1.0 / step)


def _planes(shape) -> int:
    return math.prod(shape[:-2])


def _require_cuda(name: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: every tensor must be on the same CUDA device, got {t.device}")
        if t.device != tensors[0].device:
            raise ValueError(f"{name}: tensors lie on {tensors[0].device} and {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensor data must be 16-byte aligned")


def contiguous_aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the kernels take it: contiguous, data 16-byte aligned.
    Copies only when ``t`` is not so already."""
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def launch_on_card(index: int, launch, *args):
    """``launch(lib, *args, stream)`` with the kernel library and the current
    stream of card ``index``, inside that card's device context only when
    another card is current. The raw stream comes from the call torch's own
    generated code uses (``torch._C._cuda_getCurrentRawStream``), where this
    torch has it."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    stream = raw(index) if raw is not None else torch.cuda.current_stream(index).cuda_stream
    if torch.cuda.current_device() == index:
        return launch(_build.library(), *args, stream)
    with torch.cuda.device(index):
        return launch(_build.library(), *args, stream)


# ---------------------------------------------------------------------------
# K1: icon
# ---------------------------------------------------------------------------


def _check_icon(x: torch.Tensor, depth: int) -> None:
    if depth < 1:
        raise ValueError("depth must be >= 1")
    if x.dtype != torch.uint8:
        raise ValueError(f"icon wants uint8, got {x.dtype}")
    if x.ndim < 2 or x.numel() == 0:
        raise ValueError(f"icon wants a non-empty (..., H, W) tensor, got shape {tuple(x.shape)}")
    unit = 1 << depth
    if x.shape[-2] % unit or x.shape[-1] % unit:
        raise ValueError(f"H, W must be divisible by {unit} (pad first)")


def icon_plain(x: torch.Tensor, depth: int) -> torch.Tensor:
    """Depth-``depth`` uint8 icon of a padded planar ``(..., H, W)`` uint8
    tensor: exact int32 block sums over up to 6 levels scaled once, then the
    float32 chain in the reference association, then clip and truncate."""
    _check_icon(x, depth)
    m = min(depth, _EXACT_ICON_LEVELS)
    s = x.to(torch.int32)
    for _ in range(m):
        s = s[..., 0::2, :] + s[..., 1::2, :]
        s = s[..., 0::2] + s[..., 1::2]
    v = s.to(torch.float32) * _f32(0.25**m)
    for _ in range(depth - m):
        rs = v[..., 0::2, :] + v[..., 1::2, :]
        v = (rs[..., 0::2] + rs[..., 1::2]) * 0.25
    return torch.clamp(v, 0, 255).to(torch.int32).to(torch.uint8)


def _launch_icon(lib, x: torch.Tensor, depth: int, stream: int) -> torch.Tensor:
    """K1's launches through ``lib`` on ``stream`` (``x`` already checked)."""
    lead, planes = tuple(x.shape[:-2]), _planes(x.shape)
    m = min(depth, _EXACT_ICON_LEVELS)
    ho, wo = x.shape[-2] >> m, x.shape[-1] >> m
    out = torch.empty(lead + (ho, wo), dtype=torch.uint8 if depth == m else torch.float32, device=x.device)
    rc = lib.wicca_icon_u8(x.data_ptr(), out.data_ptr(), int(depth > m), planes, ho, wo, m, _f32(0.25**m),
                           stream)
    _build.check(rc, "icon")
    LAUNCHES["icon"] += 1
    remaining = depth - m
    while remaining:
        k = min(remaining, 3)
        remaining -= k
        ho, wo = ho >> k, wo >> k
        nxt = torch.empty(lead + (ho, wo), dtype=torch.float32 if remaining else torch.uint8, device=x.device)
        rc = lib.wicca_icon_f32(out.data_ptr(), nxt.data_ptr(), int(remaining > 0), planes, ho, wo, k, stream)
        _build.check(rc, "icon")
        LAUNCHES["icon"] += 1
        out = nxt
    return out


@spanned("ops.icon")
def icon(x: torch.Tensor, depth: int) -> torch.Tensor:
    """K1: icon of a padded planar ``(..., H, W)`` uint8 tensor, H and W
    divisible by ``2**depth``. One launch up to depth 6, then one launch per
    further group of <= 3 float levels."""
    _check_icon(x, depth)
    if x.device.type == "cpu":
        return icon_plain(x, depth)
    _require_cuda("icon", x)
    with torch.cuda.device(x.device):
        return _launch_icon(_build.library(), x, depth, _stream(x))


# ---------------------------------------------------------------------------
# K2: fused forward levels + deadzone quantization
# ---------------------------------------------------------------------------


def _check_dwt(x: torch.Tensor, steps: tuple) -> int:
    k = len(steps)
    if not 1 <= k <= 3:
        raise ValueError("1..3 levels per pass")
    if x.dtype not in (torch.uint8, torch.float32):
        raise ValueError(f"dwt_multilevel_quant wants uint8 or float32, got {x.dtype}")
    if x.ndim < 2 or x.numel() == 0:
        raise ValueError(f"dwt_multilevel_quant wants a non-empty (..., H, W) tensor, got {tuple(x.shape)}")
    unit = 1 << k
    if x.shape[-2] % unit or x.shape[-1] % unit:
        raise ValueError(f"H, W must be divisible by {unit}")
    return k


def _haar_raw(x: torch.Tensor):
    """Unscaled (ll, lh, hl, hh) of one level: row pairs, then column pairs."""
    rs = x[..., 0::2, :] + x[..., 1::2, :]
    rd = x[..., 0::2, :] - x[..., 1::2, :]
    rs_e, rs_o = rs[..., 0::2], rs[..., 1::2]
    rd_e, rd_o = rd[..., 0::2], rd[..., 1::2]
    return rs_e + rs_o, rs_e - rs_o, rd_e + rd_o, rd_e - rd_o


def _quant_band(band: torch.Tensor, step: float, qmax: int, dt) -> torch.Tensor:
    # clamp first: the float -> int cast then truncates toward zero
    return torch.clamp(band * _inv(step), -qmax, qmax).to(dt)


def dwt_multilevel_quant_plain(x: torch.Tensor, steps: tuple):
    """``k = len(steps)`` <= 3 Haar levels with deadzone-quantized details.

    From uint8 the levels run on exact int32 sums and a level-l band is
    ``f32(raw) * 0.25**l``; from float32 every level scales by 0.25. A
    level's codes are int8 when ``127.5 / min(step) < 128``, else int16.
    Returns ``(ll_f32, [(lh, hl, hh), ...])`` fine to coarse."""
    k = _check_dwt(x, steps)
    steps = _band_steps3(steps)
    from_u8 = x.dtype == torch.uint8
    cur = x.to(torch.int32) if from_u8 else x
    details = []
    for lvl in range(1, k + 1):
        ll, lh, hl, hh = _haar_raw(cur)
        scale = _f32(0.25**lvl) if from_u8 else 0.25
        dt, qmax = _detail_dtype(min(steps[lvl - 1]))
        details.append(tuple(
            _quant_band(b.to(torch.float32) * scale, s, qmax, dt)
            for b, s in zip((lh, hl, hh), steps[lvl - 1])
        ))
        cur = ll if from_u8 else ll * 0.25
    ll = cur.to(torch.float32) * _f32(0.25**k) if from_u8 else cur
    return ll, details


class DwtPass:
    """One K2 launch of a fixed geometry with its arguments packed once: the
    input's shape and dtype and the pass's (lh, hl, hh) step triples fix
    every output's shape and dtype and the kernel's step and width arrays.
    It holds no tensor; :meth:`launch` allocates fresh outputs each call.

    With ``stack``, a level whose bands each fill a multiple of 16 bytes is
    one ``(3, ..., h, w)`` allocation, its bands the three views of
    ``unbind(0)``, made after the launch: three fewer allocations before
    the kernel is queued."""

    __slots__ = ("k", "u8", "planes", "h", "w", "levels", "ll_shape", "invs", "is16")

    def __init__(self, shape, dtype, steps: tuple, stack: bool = False):
        k = len(steps)
        lead, h, w = tuple(shape[:-2]), shape[-2], shape[-1]
        dts = [_detail_dtype(min(s))[0] for s in steps]
        self.k, self.u8, self.planes, self.h, self.w = k, int(dtype == torch.uint8), _planes(shape), h >> k, w >> k
        self.levels = []  # (band shape, dtype, bytes a band where the level is one allocation, else None)
        for lvl, dt in enumerate(dts, start=1):
            band = lead + (h >> lvl, w >> lvl)
            size = math.prod(band) * dt.itemsize
            self.levels.append((band, dt, size if stack and size % 16 == 0 else None))
        self.ll_shape = lead + (h >> k, w >> k)
        self.invs = (ctypes.c_float * 9)(*(_inv(s) for lvl in steps for s in lvl))
        self.is16 = (ctypes.c_int * 3)(*(int(dt == torch.int16) for dt in dts))

    def launch(self, lib, x: torch.Tensor, stream: int):
        """K2 through ``lib`` on ``stream`` (``x`` of this geometry, checked):
        ``(ll_f32, [(lh, hl, hh), ...])`` fine to coarse."""
        dev = x.device
        outs, ptrs = [], []
        for band, dt, size in self.levels:
            if size is None:
                out = tuple(torch.empty(band, dtype=dt, device=dev) for _ in range(3))
                ptrs += [b.data_ptr() for b in out]
            else:
                out = torch.empty((3,) + band, dtype=dt, device=dev)
                p = out.data_ptr()
                ptrs += [p, p + size, p + 2 * size]
            outs.append(out)
        ll = torch.empty(self.ll_shape, dtype=torch.float32, device=dev)
        rc = lib.wicca_dwt_quant(x.data_ptr(), self.u8, self.planes, self.h, self.w, self.k,
                                 (ctypes.c_void_p * 9)(*ptrs), ll.data_ptr(), self.invs, self.is16, stream)
        _build.check(rc, "dwt_multilevel_quant")
        LAUNCHES["dwt_multilevel_quant"] += 1
        return ll, [out if type(out) is tuple else out.unbind(0) for out in outs]


def _launch_dwt(lib, x: torch.Tensor, steps: tuple, stream: int):
    """K2's launch through ``lib`` on ``stream`` (``x`` already checked;
    ``steps`` in (lh, hl, hh) triples)."""
    return DwtPass(x.shape, x.dtype, steps).launch(lib, x, stream)


@spanned("ops.dwt_multilevel_quant")
def dwt_multilevel_quant(x: torch.Tensor, steps: tuple):
    """K2: one fused pass of :func:`dwt_multilevel_quant_plain`; ``x`` is
    ``(..., H, W)`` uint8 or float32 with H, W divisible by ``2**len(steps)``."""
    _check_dwt(x, steps)
    if x.device.type == "cpu":
        return dwt_multilevel_quant_plain(x, steps)
    _require_cuda("dwt_multilevel_quant", x)
    with torch.cuda.device(x.device):
        return _launch_dwt(_build.library(), x, _band_steps3(steps), _stream(x))


# ---------------------------------------------------------------------------
# K3: dequantization + fused inverse levels
# ---------------------------------------------------------------------------


def _check_idwt(ll: torch.Tensor, details, steps: tuple) -> int:
    k = len(steps)
    if not 1 <= k <= 3 or len(details) != k:
        raise ValueError("1..3 levels per pass; details must match steps")
    if ll.dtype != torch.float32:
        raise ValueError(f"ll must be float32, got {ll.dtype}")
    if ll.ndim < 2 or ll.numel() == 0:
        raise ValueError(f"ll must be a non-empty (..., h, w) tensor, got {tuple(ll.shape)}")
    ch, cw = ll.shape[-2], ll.shape[-1]
    for lvl, bands in enumerate(details, start=1):
        want = tuple(ll.shape[:-2]) + (ch << (k - lvl), cw << (k - lvl))
        if len(bands) != 3:
            raise ValueError("each level needs (lh, hl, hh)")
        for b in bands:
            if tuple(b.shape) != want:
                raise ValueError(f"level {lvl} band has shape {tuple(b.shape)}, expected {want}")
            if b.dtype not in (torch.int8, torch.int16) or b.dtype != bands[0].dtype:
                raise ValueError(f"level {lvl} codes must all be int8 or all int16")
    return k


def _fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` with one rounding, as a fused multiply-add.

    The float64 product is exact; TwoSum gives the exact error of the
    float64 sum, which then rounds to odd, so the final rounding to float32
    is the correctly rounded result (53 >= 24 + 2 bits)."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    bump = (err != 0) & ((s.view(torch.int64) & 1) == 0)
    toward = torch.where(err > 0, math.inf, -math.inf).to(s.dtype)
    return torch.where(bump, torch.nextafter(s, toward), s).to(torch.float32)


def _idwt_level_dequant(ll, codes, steps, offset: float) -> torch.Tensor:
    """One dequantizing inverse level with the reference's roundings.

    ``u = q + offset * sign q`` per band. As XLA compiles the JAX kernel,
    the LH product joins ``ll +- lh`` and the HL product joins ``hl +- hh``
    as fused multiply-adds (one rounding each); the HH product is rounded
    on its own. The CUDA kernel does the same with ``__fmaf_rn``."""
    qf = [q.to(torch.float32) for q in codes]
    u_lh, u_hl, u_hh = (q + torch.sign(q) * _f32(offset) for q in qf)
    s_lh, s_hl, s_hh = (torch.tensor(_f32(s), dtype=torch.float32, device=ll.device) for s in steps)
    d_hh = u_hh * s_hh
    rs_e = _fma_f32(u_lh, s_lh, ll) * 2.0
    rs_o = _fma_f32(-u_lh, s_lh, ll) * 2.0
    rd_e = _fma_f32(u_hl, s_hl, d_hh) * 2.0
    rd_o = _fma_f32(u_hl, s_hl, -d_hh) * 2.0
    e_r = _interleave((rs_e + rd_e) * 0.5, (rs_o + rd_o) * 0.5, axis=-1)
    o_r = _interleave((rs_e - rd_e) * 0.5, (rs_o - rd_o) * 0.5, axis=-1)
    return _interleave(e_r, o_r, axis=-2)


def idwt_multilevel_dequant_plain(ll: torch.Tensor, details, steps: tuple, emit_u8: bool = False,
                                  recon_offset: float = 0.5) -> torch.Tensor:
    """Dequantize ``(q + offset * sign q) * f32(step)`` and invert
    ``len(steps)`` <= 3 Haar levels, coarse to fine, with the reference's
    roundings (:func:`_idwt_level_dequant`). ``details`` is ``[(lh, hl, hh),
    ...]`` fine to coarse. float32 out, or uint8 (clip, truncate) with
    ``emit_u8``."""
    k = _check_idwt(ll, details, steps)
    steps = _band_steps3(steps)
    x = ll
    for lvl in range(k, 0, -1):
        x = _idwt_level_dequant(x, details[lvl - 1], steps[lvl - 1], recon_offset)
    if emit_u8:
        x = torch.clamp(x, 0, 255).to(torch.int32).to(torch.uint8)
    return x


class IdwtPass:
    """One K3 launch of a fixed geometry with its arguments packed once: the
    LL's shape, each level's code dtype, the step triples, ``emit_u8`` and
    ``recon_offset`` fix the output and the kernel's step and width arrays.
    It holds no tensor; :meth:`launch` allocates a fresh output each call."""

    __slots__ = ("k", "planes", "ch", "cw", "out_shape", "out_dtype", "steps", "is16", "offset", "u8")

    def __init__(self, ll_shape, code_dtypes, steps: tuple, emit_u8: bool, recon_offset: float):
        k = len(steps)
        self.k, self.planes, self.ch, self.cw = k, _planes(ll_shape), ll_shape[-2], ll_shape[-1]
        self.out_shape = tuple(ll_shape[:-2]) + (self.ch << k, self.cw << k)
        self.out_dtype = torch.uint8 if emit_u8 else torch.float32
        self.steps = (ctypes.c_float * 9)(*(_f32(s) for lvl in steps for s in lvl))
        self.is16 = (ctypes.c_int * 3)(*(int(dt == torch.int16) for dt in code_dtypes))
        self.offset, self.u8 = _f32(recon_offset), int(emit_u8)

    def launch(self, lib, ll: torch.Tensor, details, stream: int) -> torch.Tensor:
        """K3 through ``lib`` on ``stream`` (``ll`` and ``details``, fine to
        coarse, of this geometry, checked)."""
        out = torch.empty(self.out_shape, dtype=self.out_dtype, device=ll.device)
        ptrs = (ctypes.c_void_p * 9)(*(b.data_ptr() for bands in details for b in bands))
        rc = lib.wicca_idwt_dequant(ll.data_ptr(), ptrs, self.is16, self.steps, self.offset, self.k, self.planes,
                                    self.ch, self.cw, out.data_ptr(), self.u8, stream)
        _build.check(rc, "idwt_multilevel_dequant")
        LAUNCHES["idwt_multilevel_dequant"] += 1
        return out


def _launch_idwt(lib, ll: torch.Tensor, details, steps: tuple, emit_u8: bool, recon_offset: float,
                 stream: int) -> torch.Tensor:
    """K3's launch through ``lib`` on ``stream`` (inputs already checked;
    ``steps`` in (lh, hl, hh) triples)."""
    return IdwtPass(ll.shape, [bands[0].dtype for bands in details], steps, emit_u8,
                    recon_offset).launch(lib, ll, details, stream)


@spanned("ops.idwt_multilevel_dequant")
def idwt_multilevel_dequant(ll: torch.Tensor, details, steps: tuple, emit_u8: bool = False,
                            recon_offset: float = 0.5) -> torch.Tensor:
    """K3: one fused pass of :func:`idwt_multilevel_dequant_plain`."""
    _check_idwt(ll, details, steps)
    if ll.device.type == "cpu":
        return idwt_multilevel_dequant_plain(ll, details, steps, emit_u8, recon_offset)
    _require_cuda("idwt_multilevel_dequant", ll, *(b for bands in details for b in bands))
    with torch.cuda.device(ll.device):
        lib = _build.library()
        return _launch_idwt(lib, ll, details, _band_steps3(steps), emit_u8, recon_offset, _stream(ll))


# ---------------------------------------------------------------------------
# K4: one Haar level + deadzone quantization (or float details)
# ---------------------------------------------------------------------------


def _level_mode(step: float, quantize: bool):
    """(detail dtype, qmax, kernel mode): int8 codes, int16 codes, or float32."""
    if not quantize:
        return torch.float32, 0, 2
    dt, qmax = _detail_dtype(step)
    return dt, qmax, int(dt == torch.int16)


def _check_level(x: torch.Tensor) -> None:
    if x.ndim < 2 or x.numel() == 0:
        raise ValueError(f"dwt_level_quant wants a non-empty (..., H, W) tensor, got {tuple(x.shape)}")
    if x.shape[-2] % 2 or x.shape[-1] % 2:
        raise ValueError("H and W must be even")


def dwt_level_quant_plain(x: torch.Tensor, step: float = 1.0, quantize: bool = True):
    """One Haar level over ``(..., H, W)`` (cast to float32), H and W even.
    Returns ``(ll_f32, lh, hl, hh)`` of shape ``(..., H'/2, W'/2)``, where
    H', W' are H, W edge-padded to tile multiples when above the caps.
    Details are deadzone codes (int8 iff ``127.5 / step < 128``, else int16)
    or, with ``quantize=False``, float32."""
    _check_level(x)
    xp, _, _ = _tiling(x.to(torch.float32))
    ll, lh, hl, hh = (b * 0.25 for b in _haar_raw(xp))
    if quantize:
        dt, qmax, _ = _level_mode(step, quantize)
        lh, hl, hh = (_quant_band(b, step, qmax, dt) for b in (lh, hl, hh))
    return ll, lh, hl, hh


def _launch_dwt_level(lib, x: torch.Tensor, step: float, quantize: bool, stream: int):
    """K4's launch through ``lib`` on ``stream`` (``x`` float32, checked)."""
    h, w = x.shape[-2], x.shape[-1]
    ho, wo = _tiled_extent(h, _TILE_H)[0] // 2, _tiled_extent(w, _TILE_W)[0] // 2
    dt, qmax, mode = _level_mode(step, quantize)
    shape = tuple(x.shape[:-2]) + (ho, wo)
    ll = torch.empty(shape, dtype=torch.float32, device=x.device)
    bands = [torch.empty(shape, dtype=dt, device=x.device) for _ in range(3)]
    rc = lib.wicca_dwt_level(x.data_ptr(), _planes(x.shape), h, w, ho, wo, ll.data_ptr(),
                             *(b.data_ptr() for b in bands), mode, _inv(step) if quantize else 0.0, float(qmax),
                             stream)
    _build.check(rc, "dwt_level_quant")
    LAUNCHES["dwt_level_quant"] += 1
    return (ll, *bands)


@spanned("ops.dwt_level_quant")
def dwt_level_quant(x: torch.Tensor, step: float = 1.0, quantize: bool = True):
    """K4: :func:`dwt_level_quant_plain` in one launch; the tile padding is
    an index clamp in the kernel."""
    _check_level(x)
    if x.device.type == "cpu":
        return dwt_level_quant_plain(x, step, quantize)
    x = contiguous_aligned(x.to(torch.float32))
    _require_cuda("dwt_level_quant", x)
    with torch.cuda.device(x.device):
        return _launch_dwt_level(_build.library(), x, step, quantize, _stream(x))


# ---------------------------------------------------------------------------
# K5: dequantization (offset 0.5) + one inverse Haar level
# ---------------------------------------------------------------------------


def _check_idwt_level(ll: torch.Tensor, bands, quantize: bool) -> None:
    if ll.ndim < 2 or ll.numel() == 0:
        raise ValueError(f"ll must be a non-empty (..., h, w) tensor, got {tuple(ll.shape)}")
    for b in bands:
        if b.shape != ll.shape:
            raise ValueError(f"bands must have the shape of ll {tuple(ll.shape)}, got {tuple(b.shape)}")
    if quantize and any(b.dtype not in (torch.int8, torch.int16) or b.dtype != bands[0].dtype for b in bands):
        raise ValueError("codes must all be int8 or all int16")


def _level_grid(h: int, w: int) -> tuple[int, int]:
    """The band grid K5 inverts: above half the tile caps, a multiple of them."""
    return _tiled_extent(h, _TILE_H // 2)[0], _tiled_extent(w, _TILE_W // 2)[0]


def idwt_level_dequant_plain(ll: torch.Tensor, lh, hl, hh, step: float = 1.0, quantize: bool = True):
    """Inverse of :func:`dwt_level_quant_plain`: ``(..., h, w)`` bands,
    edge-padded to multiples of (256, 512) when above them, dequantized as
    ``(q + 0.5 sign q) * f32(step)`` (or taken as float32 with
    ``quantize=False``) -> float32 ``(..., 2h', 2w')``."""
    _check_idwt_level(ll, (lh, hl, hh), quantize)
    hp, wp = _level_grid(ll.shape[-2], ll.shape[-1])

    def prep(a):
        return _pad_dim_to(_pad_dim_to(a, -2, hp), -1, wp)

    ll = prep(ll.to(torch.float32))
    if quantize:
        return _idwt_level_dequant(ll, [prep(b) for b in (lh, hl, hh)], (step,) * 3, 0.5)
    return idwt2_level(ll, *(prep(b.to(torch.float32)) for b in (lh, hl, hh)))


def _launch_idwt_level(lib, ll: torch.Tensor, bands, step: float, quantize: bool, stream: int) -> torch.Tensor:
    """K5's launch through ``lib`` on ``stream`` (inputs checked; ``ll`` and
    float bands float32)."""
    h, w = ll.shape[-2], ll.shape[-1]
    hp, wp = _level_grid(h, w)
    mode = int(bands[0].dtype == torch.int16) if quantize else 2
    out = torch.empty(tuple(ll.shape[:-2]) + (2 * hp, 2 * wp), dtype=torch.float32, device=ll.device)
    rc = lib.wicca_idwt_level(ll.data_ptr(), *(b.data_ptr() for b in bands), _planes(ll.shape), h, w, hp, wp,
                              mode, _f32(step), out.data_ptr(), stream)
    _build.check(rc, "idwt_level_dequant")
    LAUNCHES["idwt_level_dequant"] += 1
    return out


@spanned("ops.idwt_level_dequant")
def idwt_level_dequant(ll: torch.Tensor, lh, hl, hh, step: float = 1.0, quantize: bool = True) -> torch.Tensor:
    """K5: :func:`idwt_level_dequant_plain` in one launch; the padding is an
    index clamp in the kernel."""
    _check_idwt_level(ll, (lh, hl, hh), quantize)
    if ll.device.type == "cpu":
        return idwt_level_dequant_plain(ll, lh, hl, hh, step, quantize)
    ll = contiguous_aligned(ll.to(torch.float32))
    bands = [contiguous_aligned(b if quantize else b.to(torch.float32)) for b in (lh, hl, hh)]
    _require_cuda("idwt_level_dequant", ll, *bands)
    with torch.cuda.device(ll.device):
        return _launch_idwt_level(_build.library(), ll, bands, step, quantize, _stream(ll))
