"""ctypes bindings of the port's entropy coders (``native/entropy.cpp``):
adaptive Rice (container codec 0) and the context-modeled range coder
(codec 1) for int8, int16 and int32 code planes (counterpart of
``wicca_tpu/native/rice.py``).

The library is built with ``g++`` at first use, from the port's own copy of
``entropy.cpp``, into ``wicca_tpu_torch/_build/native-<hash>/``
(:mod:`wicca_tpu_torch.native._cxx`). Nothing runs when the module is
imported. ctypes releases the GIL during a call, so planes coded from a
thread pool run in parallel.

One difference from the reference, on purpose: the reference falls back to
numpy ``RAW0``/``RAW1`` planes when its library is missing, which changes the
container's bytes. Here a library that cannot be built or loaded makes every
coder raise :class:`RuntimeError` with the compiler command; nothing falls
back. :func:`rice_decode` still reads ``RAW0``/``RAW1`` planes, since the
reference may have written them.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import numpy as np

from wicca_tpu_torch.native import _cxx

_DIR = Path(__file__).resolve().parent
SOURCE = _DIR / "entropy.cpp"
BUILD_ROOT = _cxx.BUILD_ROOT
CXX = _cxx.CXX
CXX_FLAGS = _cxx.BASE_FLAGS
_WHAT = "the entropy library"

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def build_command(cxx: str, out: Path) -> list[str]:
    """The compiler command that builds the library into ``out``."""
    return _cxx.command(cxx, CXX_FLAGS, (SOURCE,), (), out)


def build(cxx: str | None = None, root: Path | None = None) -> Path:
    """Build the library (once per source and command) and return its path;
    raises :class:`RuntimeError` naming the command when it cannot."""
    return _cxx.build("wicca_entropy", (SOURCE,), CXX_FLAGS, (), CXX if cxx is None else cxx,
                      BUILD_ROOT if root is None else root, _WHAT)


def _declare(lib: ctypes.CDLL) -> None:
    p, z = ctypes.c_char_p, ctypes.c_size_t
    for bits in (8, 16, 32):
        for name, argt in ((f"wicca_rice_encode_i{bits}", [p, z, p, z]), (f"wicca_rice_decode_i{bits}", [p, z, p, z]),
                           (f"wicca_rc_encode_i{bits}", [p, z, z, z, p, z]),
                           (f"wicca_rc_decode_i{bits}", [p, z, p, z, z, z])):
            fn = getattr(lib, name)
            fn.argtypes = argt
            fn.restype = z


def library() -> ctypes.CDLL:
    """The entropy library, built on the first call of the process."""
    global _lib
    with _lock:
        if _lib is None:
            so = build()
            lib = _cxx.open_library(so, build_command(CXX, so), _WHAT)
            _declare(lib)
            _lib = lib
    return _lib


# dtype -> (bits, Rice bytes per value at worst)
_WIDTHS = {np.dtype(np.int8): (8, 3), np.dtype(np.int16): (16, 4), np.dtype(np.int32): (32, 7)}


def _width(dtype) -> int:
    dtype = np.dtype(dtype)
    if dtype not in _WIDTHS:
        raise TypeError(f"codes must be int8/int16/int32, got {dtype}")
    return _WIDTHS[dtype][0]


def rice_encode(codes: np.ndarray) -> bytes:
    """Entropy-code an int8/int16/int32 code plane (any shape, raveled)."""
    codes = np.ascontiguousarray(codes)
    bits = _width(codes.dtype)
    flat = codes.ravel()
    if flat.size == 0:
        return b""
    lib = library()
    cap = flat.size * _WIDTHS[codes.dtype][1] + 4096
    out = np.empty(cap, dtype=np.uint8)
    n = getattr(lib, f"wicca_rice_encode_i{bits}")(flat.ctypes.data_as(ctypes.c_char_p), flat.size,
                                                   out.ctypes.data_as(ctypes.c_char_p), cap)
    if n == 0:
        raise RuntimeError("rice encode overflow")
    return out[:n].tobytes()


def _unzigzag(u: np.ndarray) -> np.ndarray:
    u = u.astype(np.uint32)
    return (u >> 1).astype(np.int32) ^ -(u & 1).astype(np.int32)


def rice_decode(data: bytes, n: int, dtype=np.int8) -> np.ndarray:
    """Inverse of :func:`rice_encode`: ``n`` codes of ``dtype``. Also reads
    the reference's numpy ``RAW0`` (16-bit) and ``RAW1`` (32-bit) planes."""
    dtype = np.dtype(dtype)
    bits = _width(dtype)
    if data[:4] == b"RAW0":
        return _unzigzag(np.frombuffer(data[4:], dtype=np.uint16, count=n)).astype(dtype)
    if data[:4] == b"RAW1":
        return _unzigzag(np.frombuffer(data[4:], dtype=np.uint32, count=n)).astype(dtype)
    out = np.empty(n, dtype=dtype)
    if n == 0:
        return out
    used = getattr(library(), f"wicca_rice_decode_i{bits}")(data, len(data), out.ctypes.data_as(ctypes.c_char_p), n)
    if used == 0:
        raise RuntimeError("rice decode error")
    return out


def _planes3(shape) -> tuple[int, int, int]:
    shp = tuple(int(s) for s in shape)
    if len(shp) == 2:
        return (1, *shp)
    if len(shp) != 3:
        raise ValueError(f"codes must be (h,w) or (planes,h,w), got shape {shp}")
    return shp


def rc_encode(codes: np.ndarray) -> bytes:
    """Range-code an int8/int16/int32 ``(h, w)`` or ``(planes, h, w)``
    stack; the 2-D geometry drives the causal-neighbour context model."""
    codes = np.ascontiguousarray(codes)
    bits = _width(codes.dtype)
    planes, h, w = _planes3(codes.shape)
    if codes.size == 0:
        return b""
    lib = library()
    cap = codes.size * codes.dtype.itemsize * 2 + 4096
    out = np.empty(cap, dtype=np.uint8)
    n = getattr(lib, f"wicca_rc_encode_i{bits}")(codes.ctypes.data_as(ctypes.c_char_p), planes, h, w,
                                                 out.ctypes.data_as(ctypes.c_char_p), cap)
    if n == 0:
        raise RuntimeError("rc encode overflow")
    return out[:n].tobytes()


def rc_decode(data: bytes, shape: tuple, dtype=np.int8) -> np.ndarray:
    """Inverse of :func:`rc_encode`: an array of ``shape`` ((h, w) or
    (planes, h, w)) and ``dtype``."""
    dtype = np.dtype(dtype)
    bits = _width(dtype)
    planes, h, w = _planes3(shape)
    out = np.empty((planes, h, w), dtype=dtype)
    if out.size:
        used = getattr(library(), f"wicca_rc_decode_i{bits}")(data, len(data), out.ctypes.data_as(ctypes.c_char_p),
                                                              planes, h, w)
        if used == 0:
            raise RuntimeError("rc decode error")
    return out.reshape(tuple(int(s) for s in shape))
