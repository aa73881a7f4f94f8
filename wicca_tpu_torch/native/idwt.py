"""ctypes bindings of the port's host Haar and 5/3 levels
(``native/idwt.cpp``): the forward Haar level with deadzone quantization of
the host encode, the float and integer Haar synthesis levels and the
tile-clamped 5/3 unlifting of the host decode (counterpart of the
``wicca_tpu/native`` functions of the same names).

Built with ``g++ -ffp-contract=off`` at first use, from the port's own copy
of ``idwt.cpp``, into ``wicca_tpu_torch/_build/native-<hash>/``
(:mod:`wicca_tpu_torch.native._cxx`): every float32 operation rounds on its
own, as the numpy mirrors round them. A library that cannot be built or
loaded raises naming the command. ctypes releases the GIL during a call;
each function also splits its rows over ``nthreads`` threads itself.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

from wicca_tpu_torch.native import _cxx

SOURCE = Path(__file__).resolve().parent / "idwt.cpp"
BUILD_ROOT = _cxx.BUILD_ROOT
CXX = _cxx.CXX
CXX_FLAGS = _cxx.BASE_FLAGS + ("-ffp-contract=off", "-pthread")
_WHAT = "the host IDWT library"

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def build_command(cxx: str, out: Path) -> list[str]:
    """The compiler command that builds the library into ``out``."""
    return _cxx.command(cxx, CXX_FLAGS, (SOURCE,), (), out)


def build(cxx: str | None = None, root: Path | None = None) -> Path:
    """Build the library (once per source and command) and return its path."""
    return _cxx.build("wicca_idwt", (SOURCE,), CXX_FLAGS, (), CXX if cxx is None else cxx,
                      BUILD_ROOT if root is None else root, _WHAT)


def _declare(lib: ctypes.CDLL) -> None:
    f, i, v, z = ctypes.c_float, ctypes.c_int, ctypes.c_void_p, ctypes.c_size_t
    lib.wicca_idwt_haar_f32_level.argtypes = [v, z, z] + [v, z, z] * 3 + [i, f, f, f, f, z, z, z, v, z, z, i, i]
    lib.wicca_idwt_haar_int_level.argtypes = [v, z, z] + [v, z, z] * 3 + [i, z, z, z, v, z, z, i, i]
    for name in ("wicca_unlift53_v", "wicca_unlift53_h"):
        getattr(lib, name).argtypes = [v, z, z, v, z, z, v, z, z, z, z, z, z, i, i]
    lib.wicca_dwt_haar_fwd_level.argtypes = [v, z, z, i] + [v, z, z] * 4 + [i, f, f, f, f, i, z, z, z, i]
    for name in ("wicca_idwt_haar_f32_level", "wicca_idwt_haar_int_level", "wicca_unlift53_v", "wicca_unlift53_h",
                 "wicca_dwt_haar_fwd_level"):
        getattr(lib, name).restype = None


def library() -> ctypes.CDLL:
    """The host IDWT library, built on the first call of the process."""
    global _lib
    with _lock:
        if _lib is None:
            so = build()
            lib = _cxx.open_library(so, build_command(CXX, so), _WHAT)
            _declare(lib)
            _lib = lib
    return _lib
