"""Host (numpy + native C++) encode of uint8 images: the host route of the
folder encode, the forward twin of :mod:`wicca_tpu_torch.codec.host_decode`
(counterpart of ``wicca_tpu/codec/host_encode.py``).

The forward Haar cascade is a streaming 2x2 block transform
(``native/idwt.cpp`` ``wicca_dwt_haar_fwd_level``), so
:func:`wicca_tpu_torch.codec.batch.encode_folder` can encode a frame on the
host when the measured cost model says the host wins; the frame then never
crosses the host-device link.

Exactness (``tests/test_torch_host_codec.py``): the same CodeStream, plane
for plane, as :func:`wicca_tpu_torch.codec.pipeline.encode` with
``wavelet='haar'``, uint8 input and ``color='none'``, and so the same
``.wct`` bytes. For uint8 sources every cascade value is an integer raw sum
times an exact power of two, exact in float32, so the only rounding is the
final ``band * float32(1/step)`` multiply, which K2 and its twin perform
alike (clip, then truncate toward zero). Stored Haar planes are cropped to
their semantic extent, so no tile geometry needs mirroring.
"""

from __future__ import annotations

import ctypes
import time

import numpy as np
import torch

from wicca_tpu_torch.codec.host_decode import _NTHREADS, _lib, _strides, _use_native
from wicca_tpu_torch.core.pad import pad_to_multiple
from wicca_tpu_torch.core.quant import QuantSpec
from wicca_tpu_torch.utils.ema import RateEMA

_F = np.float32

# measured host encode throughput (MP/s), EMA: the host half of
# encode_folder's cost model
_mps = RateEMA(40.0, min_units=0.25)


def measured_mp_per_s() -> float:
    return _mps.rate()


def _record(mp: float, seconds: float) -> None:
    _mps.record(mp, seconds)


def supported_encode(image, wavelet: str, color: str, bit_depth: int | None, keep_alpha: bool = False) -> bool:
    """True where :func:`host_encode` gives the device encode's stream:
    Haar, no color transform, 8-bit uint8 samples."""
    if wavelet != "haar" or color != "none" or (bit_depth or 8) != 8 or keep_alpha:
        return False
    return image.dtype in (np.uint8, torch.uint8)


def _detail_dtype_np(step: float):
    """The code dtype of K2 (``ops/dwt_cuda._detail_dtype``)."""
    return (np.int8, 127) if 127.5 / step < 128.0 else (np.int16, 32767)


def _quant_np(raw: np.ndarray, scale: float, step: float, dt, qmax: int) -> np.ndarray:
    band = raw.astype(_F) * _F(scale)
    qf = band * _F(1.0 / step)
    return np.clip(qf, -qmax, qmax).astype(np.int32).astype(dt)


def _fwd_level_np(x: np.ndarray):
    """Raw integer sums of one Haar level: x (C, H, W) int -> ll, lh, hl, hh
    raw int32 (C, H/2, W/2)."""
    x = x.astype(np.int32, copy=False)
    rs = x[..., 0::2, :] + x[..., 1::2, :]
    rd = x[..., 0::2, :] - x[..., 1::2, :]
    ll = rs[..., 0::2] + rs[..., 1::2]
    lh = rs[..., 0::2] - rs[..., 1::2]
    hl = rd[..., 0::2] + rd[..., 1::2]
    hh = rd[..., 0::2] - rd[..., 1::2]
    return ll, lh, hl, hh


def _fwd_level_native(x: np.ndarray, scale: float, steps, dt, qmax: int):
    c, h, w = x.shape
    hh_, ww_ = h // 2, w // 2
    ll = np.empty((c, hh_, ww_), np.int32)
    bands = [np.empty((c, hh_, ww_), dt) for _ in range(3)]
    xp, xcs, xrs = _strides(x)
    args = [ctypes.c_void_p(xp), xrs, xcs, int(x.dtype == np.uint8)]
    for a in (ll, *bands):
        ap, acs, ars = _strides(a)
        args += [ctypes.c_void_p(ap), ars, acs]
    _lib().wicca_dwt_haar_fwd_level(
        *args, int(dt == np.int16), _F(scale), _F(1.0 / steps[0]), _F(1.0 / steps[1]), _F(1.0 / steps[2]),
        qmax, c, hh_, ww_, _NTHREADS,
    )
    return ll, bands


def host_encode(image, levels: int = 5, spec: QuantSpec = QuantSpec(), mode: str = "replicate",
                constant: int = 0):
    """Encode a planar uint8 ``(..., H, W)`` image (numpy, or a CPU tensor)
    on the host; returns the CodeStream of ``pipeline.encode(...,
    wavelet='haar')`` with its planes as CPU tensors."""
    from wicca_tpu_torch.codec.pipeline import CodeStream

    t0 = time.perf_counter()
    if isinstance(image, torch.Tensor):
        if image.device.type != "cpu":
            raise ValueError(f"host_encode codes host data; the image lies on {image.device}")
        image = image.numpy()
    x = np.asarray(image)
    if x.dtype != np.uint8:
        raise TypeError(f"host_encode wants uint8, got {x.dtype}")
    lead = x.shape[:-2]
    orig = (x.shape[-2], x.shape[-1])
    x = pad_to_multiple(torch.from_numpy(np.ascontiguousarray(x)), 1 << levels, mode=mode, constant=constant).numpy()
    raw = x.reshape((-1,) + x.shape[-2:])
    native = _use_native()
    details = []
    for lvl in range(1, levels + 1):
        steps = spec.band_steps(lvl)
        dt, qmax = _detail_dtype_np(min(steps))
        scale = 0.25 ** lvl
        if native:
            raw, bands = _fwd_level_native(np.ascontiguousarray(raw), scale, steps, dt, qmax)
        else:
            raw, lh, hl, hh = _fwd_level_np(raw)
            bands = [_quant_np(b, scale, s, dt, qmax) for b, s in zip((lh, hl, hh), steps)]
        details.append(tuple(torch.from_numpy(b.reshape(lead + b.shape[-2:])) for b in bands))
    ll = (raw.astype(_F) * _F(0.25 ** levels)).reshape(lead + raw.shape[-2:])
    stream = CodeStream(
        ll=torch.from_numpy(ll), details=tuple(details), spec=spec, levels=levels, orig_shape=orig,
        wavelet="haar", color="none", chroma_gain=1.0, layout="tiled", bit_depth=8,
    )
    _record(orig[0] * orig[1] / 1e6, time.perf_counter() - t0)
    return stream
