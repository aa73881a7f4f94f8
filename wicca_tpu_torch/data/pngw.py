"""Strip-parallel PNG writer for the folder decode's output stage
(counterpart of ``wicca_tpu/data/pngw.py``; C++ in ``native/pngw.cpp``).

It takes the decoder's planar uint8 arrays directly (PNG is natively RGB:
no interleave or channel-swap copy), filters rows with the Sub predictor
and deflates row strips in parallel. The output is standard lossless PNG,
byte for byte the reference writer's for the same input and options.

:func:`write_png` writes through cv2 (same pixels, other bytes) where the
native writer is unavailable, as the reference does: where
``WICCA_TPU_NO_NATIVE_PNG`` is set, or where the library does not build
(a host without zlib's headers); the build error is logged then.
"""

from __future__ import annotations

import ctypes
import logging
import os

import numpy as np

from wicca_tpu_torch.native import pngw as _native

# zlib level 1 + Z_RLE: run-length-only matching is several times faster
# than full LZ77 and nearly as small on Sub-filtered photographic rows
# (strategy: 0 default, 1 RLE, 2 filtered)
_DEFAULT_LEVEL = 1
_DEFAULT_STRATEGY = 1
_NTHREADS = max(1, os.cpu_count() or 1)


def available() -> bool:
    """Whether the native writer can run here (it is built on the first
    call); a build failure is logged with its command."""
    if os.environ.get("WICCA_TPU_NO_NATIVE_PNG"):
        return False
    try:
        _native.library()
    except RuntimeError as e:
        logging.warning(f"native PNG writer unavailable: {e}")
        return False
    return True


def encode_png(planar: np.ndarray, level: int = _DEFAULT_LEVEL, strategy: int = _DEFAULT_STRATEGY,
               threads: int | None = None) -> bytes:
    """Encode planar uint8 ``(C, H, W)`` (C in 1/3/4, RGB[A] order) or
    ``(H, W)`` grayscale to PNG bytes. Raises ValueError for other shapes
    and dtypes, RuntimeError where the native writer is unavailable."""
    if os.environ.get("WICCA_TPU_NO_NATIVE_PNG"):
        raise RuntimeError("native PNG writer unavailable (WICCA_TPU_NO_NATIVE_PNG is set)")
    lib = _native.library()
    x = np.asarray(planar)
    if x.dtype != np.uint8:
        raise ValueError(f"PNG writer wants uint8, got {x.dtype}")
    if x.ndim == 2:
        x = x[None]
    if x.ndim != 3 or x.shape[0] not in (1, 3, 4):
        raise ValueError(f"expected (C in 1/3/4, H, W) or (H, W), got {x.shape}")
    c, h, w = x.shape
    if x.strides[-1] != 1:
        x = np.ascontiguousarray(x)
    nt = threads if threads is not None else _NTHREADS
    cap = lib.wicca_png_bound(h, w, c, nt)
    out = np.empty(cap, np.uint8)
    n = lib.wicca_png_encode_planar(ctypes.c_void_p(x.ctypes.data), x.strides[0], x.strides[1], h, w, c,
                                    int(level), int(strategy), nt, ctypes.c_void_p(out.ctypes.data), cap)
    if n == 0:
        raise RuntimeError("PNG encode failed")
    return out[:n].tobytes()


def write_png(path: str, planar: np.ndarray, level: int = _DEFAULT_LEVEL, threads: int | None = None) -> int:
    """Write planar uint8 to ``path`` as PNG; returns the encoded byte
    count. ``threads`` caps the deflate strips: callers that run many writes
    at once (the folder decode's pool) pass their share of the cores."""
    x = np.asarray(planar)
    if available() and x.dtype == np.uint8 and (x.ndim == 2 or (x.ndim == 3 and x.shape[0] in (1, 3, 4))):
        blob = encode_png(x, level, threads=threads)
        with open(path, "wb") as f:
            f.write(blob)
        return len(blob)
    import cv2

    from wicca_tpu_torch.data.loader import from_planar

    hwc = from_planar(x) if x.ndim == 3 else x
    if hwc.ndim == 3:
        hwc = cv2.cvtColor(hwc, cv2.COLOR_RGBA2BGRA if hwc.shape[2] == 4 else cv2.COLOR_RGB2BGR)
    cv2.imwrite(path, hwc)
    return os.path.getsize(path)
