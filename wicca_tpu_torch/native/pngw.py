"""ctypes bindings of the port's strip-parallel PNG writer
(``native/pngw.cpp``; :mod:`wicca_tpu_torch.data.pngw` is its Python
face).

Built with ``g++`` at first use, from the port's own copy of ``pngw.cpp``,
into a shared object of its own linked with ``-lz``
(:mod:`wicca_tpu_torch.native._cxx`), so that a host without zlib's headers
still builds the entropy coders and the host IDWT. A library that cannot
be built or loaded raises naming the command.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

from wicca_tpu_torch.native import _cxx

SOURCE = Path(__file__).resolve().parent / "pngw.cpp"
BUILD_ROOT = _cxx.BUILD_ROOT
CXX = _cxx.CXX
CXX_FLAGS = _cxx.BASE_FLAGS + ("-pthread",)
LIBS = ("-lz",)
_WHAT = "the PNG writer library"

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def build_command(cxx: str, out: Path) -> list[str]:
    """The compiler command that builds the library into ``out``."""
    return _cxx.command(cxx, CXX_FLAGS, (SOURCE,), LIBS, out)


def build(cxx: str | None = None, root: Path | None = None) -> Path:
    """Build the library (once per source and command) and return its path."""
    return _cxx.build("wicca_pngw", (SOURCE,), CXX_FLAGS, LIBS, CXX if cxx is None else cxx,
                      BUILD_ROOT if root is None else root, _WHAT)


def library() -> ctypes.CDLL:
    """The PNG writer library, built on the first call of the process."""
    global _lib
    with _lock:
        if _lib is None:
            so = build()
            lib = _cxx.open_library(so, build_command(CXX, so), _WHAT)
            u32, i, v, z = ctypes.c_uint32, ctypes.c_int, ctypes.c_void_p, ctypes.c_size_t
            lib.wicca_png_bound.argtypes = [u32, u32, u32, i]
            lib.wicca_png_bound.restype = z
            lib.wicca_png_encode_planar.argtypes = [v, z, z, u32, u32, u32, i, i, i, v, z]
            lib.wicca_png_encode_planar.restype = z
            _lib = lib
    return _lib
