"""Host (numpy + native C++) decode of CodeStreams: the host route of the
folder decode (counterpart of ``wicca_tpu/codec/host_decode.py``).

:func:`wicca_tpu_torch.codec.batch.decode_folder` picks the host or the
device route per frame with a measured cost model; this module decodes a
stream on the host without touching a device, so a frame routed here never
crosses the host-device link.

What it gives, held by ``tests/test_torch_host_codec.py`` against the
reference's own host decode and against the port's :func:`decode`:

* ``haar`` (float path): the reference host route's output bit for bit.
  The synthesis keeps the fused kernel's float32 association
  (dequantize ``(q + off*sign(q)) * step``, butterflies ``(ll +- lh) * 2``,
  ``* 0.5``, interleave), every operation rounded on its own
  (``native/idwt.cpp`` is built with ``-ffp-contract=off``). The device
  route (K3, and its plain twin) fuses the LH and HL dequantization
  products into fused multiply-adds, as the reference's Pallas kernel does
  on the CPU. So the two routes agree bit for bit exactly where those
  products are exact in float32: power-of-two steps, and any step whose
  products of the stream's codes need no rounding (0.75, 1.5, 3 at offset
  0.5); at a step such as 0.1, or offset 0.3 with step 0.75, they differ
  in the last float bit, in the reference and in the port alike.
  :func:`agrees_with_device` says which case a stream is, and ``auto``
  routing sends the others to the device.
* ``haar_int``, tiled ``legall5.3`` (a numpy/native mirror of the tile-local
  kernel grid) and integer wavelets with ``layout='global'``: exact.
* ``rct``: exact. ``ict``: float32, within 1 gray level of the device.

Tiled float wavelets (``bior4.4``, ``cdf97``, ``db2``) and ROI streams are
decoded by the device route only (:func:`supported` is False).

The port's K2 always stores detail bands in their spatial ``(h, w)``
orientation (the reference can store some transposed when its
``dwt_pallas._T_LVLS`` is set, and then refuses the host route), so every
Haar stream the port writes or reads is supported here.
"""

from __future__ import annotations

import ctypes
import functools
import os
import time

import numpy as np
import torch

from wicca_tpu_torch.codec.pipeline import _pass_partition, _scaled_steps
from wicca_tpu_torch.core.lifting import is_integer_wavelet
from wicca_tpu_torch.native import idwt as _native
from wicca_tpu_torch.utils.ema import RateEMA

_F = np.float32
_NTHREADS = max(1, os.cpu_count() or 1)


def _use_native() -> bool:
    """The C++ levels unless ``WICCA_TPU_NO_NATIVE_IDWT`` asks for the numpy
    mirrors (the library is built at first use and raises if it cannot)."""
    return not os.environ.get("WICCA_TPU_NO_NATIVE_IDWT")


def _lib():
    return _native.library()


def _strides(a: np.ndarray) -> tuple[int, int, int]:
    """Data pointer and (channel, row) element strides of a 3-D array."""
    it = a.dtype.itemsize
    return a.ctypes.data, a.strides[-3] // it, a.strides[-2] // it


def _np(t) -> np.ndarray:
    """A stream plane as a host numpy array (CUDA tensors are copied)."""
    if isinstance(t, torch.Tensor):
        return t.numpy() if t.device.type == "cpu" else t.cpu().numpy()
    return np.asarray(t)


def _native_haar_f32_level(x, lh, hl, hh, steps, offset, emit_u8):
    c, h, w = x.shape
    out = np.empty((c, h * 2, w * 2), np.uint8 if emit_u8 else _F)
    xp, xcs, xrs = _strides(x)
    args = [ctypes.c_void_p(xp), xrs, xcs]
    for b in (lh, hl, hh):
        bp, bcs, brs = _strides(b)
        args += [ctypes.c_void_p(bp), brs, bcs]
    op, ocs, ors = _strides(out)
    _lib().wicca_idwt_haar_f32_level(
        *args, int(lh.dtype == np.int16), _F(steps[0]), _F(steps[1]), _F(steps[2]), _F(offset),
        c, h, w, ctypes.c_void_p(op), ors, ocs, int(emit_u8), _NTHREADS,
    )
    return out


def _native_haar_int_level(x, lh, hl, hh, emit_u8):
    c, h, w = x.shape
    out = np.empty((c, h * 2, w * 2), np.uint8 if emit_u8 else np.int32)
    xp, xcs, xrs = _strides(x)
    args = [ctypes.c_void_p(xp), xrs, xcs]
    for b in (lh, hl, hh):
        bp, bcs, brs = _strides(b)
        args += [ctypes.c_void_p(bp), brs, bcs]
    op, ocs, ors = _strides(out)
    _lib().wicca_idwt_haar_int_level(
        *args, int(lh.dtype == np.int16), c, h, w, ctypes.c_void_p(op), ors, ocs, int(emit_u8), _NTHREADS,
    )
    return out


def _deq(q: np.ndarray, step: float, offset: float) -> np.ndarray:
    """Deadzone dequantization in float32, the kernel's association:
    ``(q + offset*sign(q)) * step``."""
    qf = q.astype(_F)
    return (qf + _F(offset) * np.sign(qf)) * _F(step)


def _fit(b: np.ndarray, h: int, w: int) -> np.ndarray:
    """Crop or zero-pad the last two dims to exactly (h, w), as the kernel
    pads its bands (padding synthesizes into the cropped-away region)."""
    bh, bw = b.shape[-2], b.shape[-1]
    if bh >= h and bw >= w:
        return b[..., :h, :w]
    out = np.zeros(b.shape[:-2] + (h, w), b.dtype)
    out[..., : min(bh, h), : min(bw, w)] = b[..., : min(bh, h), : min(bw, w)]
    return out


def _haar_level_f32(ll: np.ndarray, lh: np.ndarray, hl: np.ndarray, hh: np.ndarray) -> np.ndarray:
    """One float Haar synthesis level in the kernel's association (all
    scalings are exact powers of two; adds are float32 in the same order)."""
    two, half = _F(2.0), _F(0.5)
    rs_e = (ll + lh) * two
    rs_o = (ll - lh) * two
    rd_e = (hl + hh) * two
    rd_o = (hl - hh) * two
    h2, w2 = ll.shape[-2], ll.shape[-1]
    out = np.empty(ll.shape[:-2] + (h2 * 2, w2 * 2), _F)
    out[..., 0::2, 0::2] = (rs_e + rd_e) * half
    out[..., 0::2, 1::2] = (rs_o + rd_o) * half
    out[..., 1::2, 0::2] = (rs_e - rd_e) * half
    out[..., 1::2, 1::2] = (rs_o - rd_o) * half
    return out


# ---------------------------------------------------------------------------
# integer lifting (numpy mirror of core/lifting; >> on int32 = floor division)
# ---------------------------------------------------------------------------


def _shift_np(a: np.ndarray, by: int) -> np.ndarray:
    """Replicate-edge neighbour shift along the last axis."""
    if by == 0:
        return a
    out = np.empty_like(a)
    if by > 0:
        out[..., :-by] = a[..., by:]
        out[..., -by:] = a[..., -1:]
    else:
        out[..., -by:] = a[..., :by]
        out[..., : -by] = a[..., :1]
    return out


def _interleave_np(e: np.ndarray, o: np.ndarray) -> np.ndarray:
    out = np.empty(e.shape[:-1] + (e.shape[-1] * 2,), e.dtype)
    out[..., 0::2] = e
    out[..., 1::2] = o
    return out


def _haar_int_inv1d(s: np.ndarray, d: np.ndarray) -> np.ndarray:
    e = s - (d >> 1)
    return _interleave_np(e, d + e)


def _legall53_inv1d(s: np.ndarray, d: np.ndarray) -> np.ndarray:
    e = s - ((_shift_np(d, -1) + d + 2) >> 2)
    o = d + ((e + _shift_np(e, +1)) >> 1)
    return _interleave_np(e, o)


_INT_INV1D = {"haar_int": _haar_int_inv1d, "legall5.3": _legall53_inv1d, "cdf53": _legall53_inv1d}


# ---------------------------------------------------------------------------
# tile-local 5/3 (independent (512, 1024) tiles, the K7 grid and edge clamps)
# ---------------------------------------------------------------------------

_TILE_H, _TILE_W = 512, 1024


def _unlift_rows_np(s: np.ndarray, d: np.ndarray, filt: str) -> np.ndarray:
    """Inverse lifting over row pairs (axis -2), edge-clamped."""
    if filt == "haar_int":
        e = s - (d >> 1)
        o = d + e
    else:
        dp = np.concatenate([d[..., :1, :], d[..., :-1, :]], axis=-2)  # d[n-1], clamped at 0
        e = s - ((dp + d + 2) >> 2)
        en = np.concatenate([e[..., 1:, :], e[..., -1:, :]], axis=-2)  # e[n+1], clamped at the end
        o = d + ((e + en) >> 1)
    out = np.empty(e.shape[:-2] + (e.shape[-2] * 2, e.shape[-1]), e.dtype)
    out[..., 0::2, :] = e
    out[..., 1::2, :] = o
    return out


def _level53_inv_np(ll, lh, hl, hh, filt: str) -> np.ndarray:
    """One 2-D reversible inverse level, vertical then horizontal."""
    lo = _unlift_rows_np(ll, hl, filt)
    hi = _unlift_rows_np(lh, hh, filt)
    x_t = _unlift_rows_np(lo.swapaxes(-1, -2), hi.swapaxes(-1, -2), filt)
    return x_t.swapaxes(-1, -2)


def _pad_rep(x: np.ndarray, mh: int, mw: int) -> np.ndarray:
    """Replicate-pad the trailing dims to multiples of (mh, mw)."""
    eh = -x.shape[-2] % mh
    ew = -x.shape[-1] % mw
    if not eh and not ew:
        return x
    return np.pad(x, [(0, 0)] * (x.ndim - 2) + [(0, eh), (0, ew)], mode="edge")


def _fit_rep(b: np.ndarray, h: int, w: int) -> np.ndarray:
    """Replicate-pad then crop to exactly (h, w) (the kernel's band prep)."""
    if b.shape[-2] < h:
        b = np.pad(b, [(0, 0)] * (b.ndim - 2) + [(0, h - b.shape[-2]), (0, 0)], mode="edge")
    if b.shape[-1] < w:
        b = np.pad(b, [(0, 0)] * (b.ndim - 2) + [(0, 0), (0, w - b.shape[-1])], mode="edge")
    return b[..., :h, :w]


def _native_unlift(s: np.ndarray, d: np.ndarray, group: int, vertical: bool, filt: str) -> np.ndarray:
    c, r, w = s.shape
    out = np.empty((c, 2 * r, w) if vertical else (c, r, 2 * w), np.int32)
    sp, scs, srs = _strides(s)
    dp, dcs, drs = _strides(d)
    op, ocs, ors = _strides(out)
    lib = _lib()
    fn = lib.wicca_unlift53_v if vertical else lib.wicca_unlift53_h
    fn(ctypes.c_void_p(sp), srs, scs, ctypes.c_void_p(dp), drs, dcs, ctypes.c_void_p(op), ors, ocs, c, r, w, group,
       int(filt == "haar_int"), _NTHREADS)
    return out


def _tiled53_pass_inv(x: np.ndarray, dets, filt: str, orig_k: int) -> np.ndarray:
    """Invert one tile-local pass of ``len(dets)`` levels; the coarse tile
    caps come from the encoder's full pass depth ``orig_k``, so the edge
    clamps land where the forward transform clamped (K7's contract)."""
    k = len(dets)
    th_c = min(x.shape[-2], _TILE_H >> orig_k)
    tw_c = min(x.shape[-1], _TILE_W >> orig_k)
    x = _pad_rep(x, th_c, tw_c)
    c, chp, cwp = x.shape
    bands = []
    for idx in range(k):
        lvl = k - idx
        m = 1 << idx
        bands.append(tuple(_fit_rep(b.astype(np.int32), chp * m, cwp * m) for b in dets[lvl - 1]))
    unit = 1 << k
    if _use_native():
        # whole-plane native levels: clamp groups reproduce the independent
        # tiles, so this equals the per-tile loop below
        for idx in range(k):
            m = 1 << idx
            lh, hl, hh = bands[idx]
            lo = _native_unlift(x, hl, th_c * m, True, filt)
            hi = _native_unlift(lh, hh, th_c * m, True, filt)
            x = _native_unlift(lo, hi, tw_c * m, False, filt)
        return x
    out = np.empty((c, chp * unit, cwp * unit), np.int32)
    for ti in range(chp // th_c):
        for tj in range(cwp // tw_c):
            t = x[:, ti * th_c : (ti + 1) * th_c, tj * tw_c : (tj + 1) * tw_c]
            for idx in range(k):
                m = 1 << idx
                hh_, ww_ = th_c * m, tw_c * m
                lh, hl, hb = (b[:, ti * hh_ : (ti + 1) * hh_, tj * ww_ : (tj + 1) * ww_] for b in bands[idx])
                t = _level53_inv_np(t, lh, hl, hb, filt)
            u = th_c * unit
            v = tw_c * unit
            out[:, ti * u : (ti + 1) * u, tj * v : (tj + 1) * v] = t
    return out


def _rows_inv(inv, s, d):
    return inv(s.swapaxes(-1, -2), d.swapaxes(-1, -2)).swapaxes(-1, -2)


def _int_level_inv(ll, lh, hl, hh, wavelet: str) -> np.ndarray:
    inv = _INT_INV1D[wavelet]
    lo = _rows_inv(inv, ll, hl)
    hi = _rows_inv(inv, lh, hh)
    return inv(lo, hi)


# ---------------------------------------------------------------------------
# stream-level helpers (numpy mirrors of codec/pipeline internals)
# ---------------------------------------------------------------------------


def _widen_div_int_np(stream, details):
    """Integer streams with R-D divisors: codes re-widened to bin midpoints."""
    if not stream.band_div or not is_integer_wavelet(stream.wavelet):
        return details
    out = []
    for lvl, bands in enumerate(details):
        row = []
        for b, d in zip(bands, stream.band_div[lvl * 3 : lvl * 3 + 3]):
            if d != 1:
                info = np.iinfo(b.dtype)
                bi = b.astype(np.int64)
                b = (np.sign(bi) * np.minimum(np.abs(bi) * d + d // 2, info.max)).astype(b.dtype)
            row.append(b)
        out.append(tuple(row))
    return tuple(out)


def _undo_color_np(stream, x: np.ndarray) -> np.ndarray:
    if stream.color == "none":
        return x
    yuv, extra = (x[..., :3, :, :], x[..., 3:, :, :]) if x.shape[-3] == 4 else (x, None)
    if stream.color == "rct":
        v = yuv.astype(np.int32)
        y, u, w = v[..., 0, :, :], v[..., 1, :, :], v[..., 2, :, :]
        g = y - ((u + w) >> 2)
        rgb = np.stack([w + g, g, u + g], axis=-3)
    else:  # ict (BT.601) in float32: within 1 gray level of the device route
        yuv = yuv.astype(_F)
        if stream.chroma_gain != 1.0:
            yuv = yuv * np.array([1.0, stream.chroma_gain, stream.chroma_gain], _F).reshape(3, 1, 1)
        y, cb, cr = yuv[..., 0, :, :], yuv[..., 1, :, :], yuv[..., 2, :, :]
        rgb = np.stack(
            [
                _F(1.0) * y + _F(0.0) * cb + _F(1.402) * cr,
                _F(1.0) * y + _F(-0.344136) * cb + _F(-0.714136) * cr,
                _F(1.0) * y + _F(1.772) * cb + _F(0.0) * cr,
            ],
            axis=-3,
        )
    return rgb if extra is None else np.concatenate([rgb, extra.astype(rgb.dtype)], axis=-3)


def _emit_native_np(stream, x: np.ndarray) -> np.ndarray:
    peak = (1 << stream.bit_depth) - 1
    dt = np.uint8 if stream.bit_depth <= 8 else np.uint16
    if x.dtype.kind == "f":
        # the kernels' order: clip -> int32 (truncate toward zero) -> unsigned
        return np.clip(x, 0, peak).astype(np.int32).astype(dt)
    return np.clip(x, 0, peak).astype(dt)


# Measured host decode throughput (MP/s), an EMA over real host_decode
# calls: the host half of decode_folder's cost model, tracked per path (the
# native Haar levels run far faster than the tile-local 5/3). The priors
# are conservative: a cold first frame pays page faults and band copies.
_host_mps: dict[str, RateEMA] = {
    k: RateEMA(prior, min_units=0.25) for k, prior in (("haar", 40.0), ("tiled53", 4.0), ("lifting", 4.0))
}


def _rate_kind(stream) -> str:
    if stream.wavelet in ("haar", "haar_int"):
        return "haar"
    if stream.wavelet in ("legall5.3", "cdf53") and stream.layout == "tiled" and stream.bit_depth == 8:
        return "tiled53"
    return "lifting"


def measured_mp_per_s(kind: str = "haar") -> float:
    ema = _host_mps.get(kind)
    return ema.rate() if ema is not None else 4.0


def _record_mps(kind: str, mp: float, seconds: float) -> None:
    _host_mps.setdefault(kind, RateEMA(4.0, min_units=0.25)).record(mp, seconds)


def supported(stream) -> bool:
    """True if :func:`host_decode` reproduces the stream's decode. Tiled
    float wavelets and ROI streams go to the device route."""
    if stream.roi_shift:
        return False
    if stream.wavelet in ("haar", "haar_int"):
        return True  # the port's K2 stores every band in spatial orientation
    if stream.wavelet in ("legall5.3", "cdf53") and stream.bit_depth == 8:
        return True  # tiled: numpy/native mirror of the tile-local kernel
    return is_integer_wavelet(stream.wavelet) and stream.layout == "global"


@functools.lru_cache(maxsize=1024)
def _products_exact(step: float, offset: float, wide: bool) -> bool:
    """Whether ``(q + offset*sign q) * step`` is exact in float32 for every
    int8 (or, ``wide``, int16) code ``q``: then a fused multiply-add and a
    rounded product followed by an add give the same sum."""
    info = np.iinfo(np.int16 if wide else np.int8)
    q = np.arange(info.min, info.max + 1).astype(_F)
    u = q + _F(offset) * np.sign(q)
    p = u.astype(np.float64) * float(_F(step))  # exact: two 24-bit significands
    return bool(np.array_equal(p, p.astype(_F).astype(np.float64)))


def agrees_with_device(stream, recon_offset: float = 0.5) -> bool:
    """True where the host route gives the device route's output bit for
    bit, by construction: the integer paths (and ``rct``), and ``haar``
    streams whose LH and HL dequantization products are exact in float32
    (the device route fuses those two products into fused multiply-adds;
    the HH product is rounded on its own on both routes). False for
    ``ict`` (float rotation, within 1 gray level) and where
    :func:`supported` is False."""
    if not supported(stream) or stream.color == "ict":
        return False
    if stream.wavelet != "haar":
        return True
    for lvl, bands in enumerate(stream.details, start=1):
        wide = bands[0].dtype not in (torch.int8, np.int8)
        s_lh, s_hl, _ = _scaled_steps(stream.spec, stream.band_div, lvl)
        if not (_products_exact(s_lh, recon_offset, wide) and _products_exact(s_hl, recon_offset, wide)):
            return False
    return True


def host_decode(stream, emit_u8: bool = True, recon_offset: float = 0.5, target_level: int = 0) -> torch.Tensor:
    """Decode ``stream`` on the host; returns a CPU tensor (uint8, or uint16
    for high-bit-depth streams, with ``emit_u8``). See the module docstring
    for what it equals; raises ValueError where :func:`supported` is False.

    ``target_level=r`` mirrors :func:`wicca_tpu_torch.codec.pipeline.decode_at_level`
    (1/2**r resolution from the coarse subbands only)."""
    if not supported(stream):
        raise ValueError(f"no host decode path for wavelet={stream.wavelet!r} layout={stream.layout!r}")
    if not 0 <= target_level <= stream.levels:
        raise ValueError(f"target_level must be in [0, {stream.levels}]")
    t0 = time.perf_counter()
    ll = _np(stream.ll)
    details = tuple(tuple(_np(b) for b in bands) for bands in stream.details)
    lead = ll.shape[:-2]
    native = _use_native()
    # the native uint8 emission (one full-size pass fewer) applies only where
    # no color rotation follows and the samples are 8-bit
    u8_in = emit_u8 and stream.color == "none" and stream.bit_depth == 8

    def _3d(a):
        return a.reshape((-1,) + a.shape[-2:])

    def _native_codes(bands):
        return native and all(b.dtype in (np.int8, np.int16) for b in bands) and (
            bands[0].dtype == bands[1].dtype == bands[2].dtype)

    tl = target_level
    if stream.wavelet == "haar":
        x = _3d(ll).astype(_F)
        for lo, hi in reversed(_pass_partition(stream.levels)):
            if hi <= tl:
                break
            use = list(range(max(lo, tl), hi))  # a partial pass above the target
            dets = [details[i] for i in use]
            steps = [_scaled_steps(stream.spec, stream.band_div, i + 1) for i in use]
            x = x[..., : dets[-1][0].shape[-2], : dets[-1][0].shape[-1]]
            h0, w0 = x.shape[-2], x.shape[-1]
            kk = len(use)
            for idx in range(kk):  # coarse -> fine within the pass
                lvl = kk - idx
                m = 1 << idx
                st = steps[lvl - 1]
                bands = [_fit(_3d(b), h0 * m, w0 * m) for b in dets[lvl - 1]]
                last = lo == 0 and tl == 0 and idx == kk - 1
                if _native_codes(bands):
                    x = _native_haar_f32_level(x, *bands, st, recon_offset, u8_in and last)
                else:
                    lh, hl, hh = (_deq(b, st[i], recon_offset) for i, b in enumerate(bands))
                    x = _haar_level_f32(x, lh, hl, hh)
    elif stream.wavelet in ("legall5.3", "cdf53") and stream.layout == "tiled" and stream.bit_depth == 8:
        # tile-local reversible 5/3: the fused kernel's pass structure and tile grid
        details = _widen_div_int_np(stream, details)
        x = _3d(ll).astype(np.int32)
        for lo, hi in reversed(_pass_partition(stream.levels)):
            if hi <= tl:
                break
            use = [details[i] for i in range(max(lo, tl), hi)]
            x = x[..., : use[-1][0].shape[-2], : use[-1][0].shape[-1]]
            x = _tiled53_pass_inv(x, [tuple(_3d(b) for b in bands) for bands in use], "legall5.3", orig_k=hi - lo)
    elif stream.wavelet == "haar_int":
        details = _widen_div_int_np(stream, details)
        x = _3d(ll).astype(np.int32)
        for lvl in range(stream.levels, tl, -1):
            bands = [_3d(b) for b in details[lvl - 1]]
            # crop or pad to the band grid (tile-padded streams store bands
            # slightly larger; haar_int is pair-local, so zero padding never
            # reaches the valid region)
            x = _fit(x, bands[0].shape[-2], bands[0].shape[-1])
            last = lvl == tl + 1 and tl == 0
            if _native_codes(bands):
                x = _native_haar_int_level(x, *bands, u8_in and last)
            else:
                lh, hl, hh = (b.astype(np.int32) for b in bands)
                x = _int_level_inv(x, lh, hl, hh, stream.wavelet)
    else:  # other integer wavelets, global layout (high-bit-depth streams)
        details = _widen_div_int_np(stream, details)
        x = _3d(ll).astype(np.int32)
        for lvl in range(stream.levels, tl, -1):
            lh, hl, hh = (_3d(b).astype(np.int32) for b in details[lvl - 1])
            x = _fit(x, lh.shape[-2], lh.shape[-1])
            x = _int_level_inv(x, lh, hl, hh, stream.wavelet)
    x = x.reshape(lead + x.shape[-2:])
    x = _undo_color_np(stream, x)
    if emit_u8 and x.dtype not in (np.uint8, np.uint16):
        x = _emit_native_np(stream, x)
    h, w = stream.orig_shape
    out = x[..., : -(-h // (1 << tl)), : -(-w // (1 << tl))]
    _record_mps(_rate_kind(stream), h * w / (1e6 * (1 << (2 * tl))), time.perf_counter() - t0)
    return torch.from_numpy(np.ascontiguousarray(out))
