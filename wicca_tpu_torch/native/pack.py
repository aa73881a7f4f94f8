"""ctypes bindings of the port's PACK1 host side (``native/pack.cpp``): the
rebuild of int8/int16 planes from the packed buffer a card sends down, the
k-bit pack of planes going up, and the upload's escape-tail counts
(counterpart of the ``wicca_pack1_*`` functions of ``wicca_tpu/native``;
:mod:`wicca_tpu_torch.codec.transfer` is their user).

Built with ``g++`` at first use, from the port's own copy of ``pack.cpp``,
into a shared object of its own under ``wicca_tpu_torch/_build/native-<hash>/``
(:mod:`wicca_tpu_torch.native._cxx`). A library that cannot be built or
loaded raises naming the command; there is no numpy route. ctypes releases
the GIL during a call, so planes rebuilt from a thread pool run in parallel.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import numpy as np

from wicca_tpu_torch.native import _cxx

SOURCE = Path(__file__).resolve().parent / "pack.cpp"
BUILD_ROOT = _cxx.BUILD_ROOT
CXX = _cxx.CXX
CXX_FLAGS = _cxx.BASE_FLAGS
_WHAT = "the PACK1 library"

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def build_command(cxx: str, out: Path) -> list[str]:
    """The compiler command that builds the library into ``out``."""
    return _cxx.command(cxx, CXX_FLAGS, (SOURCE,), (), out)


def build(cxx: str | None = None, root: Path | None = None) -> Path:
    """Build the library (once per source and command) and return its path;
    raises :class:`RuntimeError` naming the command when it cannot."""
    return _cxx.build("wicca_pack", (SOURCE,), CXX_FLAGS, (), CXX if cxx is None else cxx,
                      BUILD_ROOT if root is None else root, _WHAT)


def library() -> ctypes.CDLL:
    """The PACK1 library, built on the first call of the process."""
    global _lib
    with _lock:
        if _lib is None:
            so = build()
            lib = _cxx.open_library(so, build_command(CXX, so), _WHAT)
            v, z, i = ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int
            for bits in (8, 16):
                fn = getattr(lib, f"wicca_pack1_reconstruct_i{bits}")
                fn.argtypes, fn.restype = [v, v, i, z, z, z, z, v], z
                fn = getattr(lib, f"wicca_pack1_pack_i{bits}")
                fn.argtypes, fn.restype = [v, z, z, i, v, v, v, z], z
                fn = getattr(lib, f"wicca_pack1_stats_i{bits}")
                fn.argtypes, fn.restype = [v, z, v], None
            _lib = lib
    return _lib


def _bits(dtype) -> int:
    return 8 if np.dtype(dtype) == np.int8 else 16


def reconstruct(fields: np.ndarray, exc: np.ndarray, k: int, n: int, npad: int, cap: int, seg: int,
                out: np.ndarray) -> int:
    """Rebuild ``out`` (int8 or int16, ``n`` samples) from k-bit ``fields``
    and the per-segment escape rows ``exc`` (``cap`` values a segment);
    returns the escapes taken. ``fields`` must be followed by 3 readable
    bytes (the rest of the packed buffer)."""
    fn = getattr(library(), f"wicca_pack1_reconstruct_i{_bits(out.dtype)}")
    return fn(fields.ctypes.data, exc.ctypes.data, k, n, npad, cap, seg, out.ctypes.data)


def pack(plane: np.ndarray, n: int, npad: int, k: int, fields: np.ndarray, pos: np.ndarray, vals: np.ndarray,
         max_corr: int) -> int:
    """Pack ``plane`` (int8 or int16, flat) into saturated k-bit ``fields``
    (``npad * k / 8`` bytes + 4 of slack) and up to ``max_corr`` (int32
    position, value) corrections; returns the corrections found."""
    fn = getattr(library(), f"wicca_pack1_pack_i{_bits(plane.dtype)}")
    return fn(plane.ctypes.data, n, npad, k, fields.ctypes.data, pos.ctypes.data, vals.ctypes.data, max_corr)


def stats(plane: np.ndarray, n: int) -> np.ndarray:
    """``counts[k-1]`` = the samples of ``plane`` (int8 or int16, flat) whose
    zigzag code is >= 2**k - 1, for k = 1 .. width-1 (int64)."""
    width = _bits(plane.dtype)
    counts = np.empty(width - 1, np.int64)
    getattr(library(), f"wicca_pack1_stats_i{width}")(plane.ctypes.data, n, counts.ctypes.data)
    return counts
