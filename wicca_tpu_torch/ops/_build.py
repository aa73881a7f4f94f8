"""Build and bind the CUDA kernels of ``wicca_tpu_torch/csrc``.

The sources are compiled by ``nvcc`` at first use into a shared library with
a plain C interface, loaded with ctypes. The library lands in
``wicca_tpu_torch/_build/<hash>/``, keyed by a hash of the sources and the
flags, so an edit rebuilds and an unchanged tree reuses the last build.
Nothing here runs when the package is imported.

``nvcc`` is taken from ``$CUDA_HOME/bin``, then from ``PATH``, then from the
toolkit's default prefix.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
SOURCES = ("haar_kernels.cu",)
HEADERS = ("haar_kernels.cuh",)
# -fmad=false: no multiply-add contraction beyond the explicit __fmaf_rn
# calls, which sit exactly where the reference rounds a product and a sum once
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lib: ctypes.CDLL | None = None
build_seconds: float | None = None  # wall time of the build this process ran (None: reused or not built)
build_log: str = ""


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put the CUDA toolkit's bin directory on PATH")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _declare(lib: ctypes.CDLL) -> None:
    vp, i64, c_int, c_float = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float
    pp = ctypes.POINTER(ctypes.c_void_p)
    lib.wicca_icon_u8.argtypes = [vp, vp, c_int, i64, i64, i64, c_int, c_float, vp]
    lib.wicca_icon_f32.argtypes = [vp, vp, c_int, i64, i64, i64, c_int, vp]
    lib.wicca_dwt_quant.argtypes = [
        vp, c_int, i64, i64, i64, c_int, pp, vp,
        ctypes.POINTER(c_float), ctypes.POINTER(c_int), vp,
    ]
    lib.wicca_idwt_dequant.argtypes = [
        vp, pp, ctypes.POINTER(c_int), ctypes.POINTER(c_float), c_float, c_int,
        i64, i64, i64, vp, c_int, vp,
    ]
    for fn in (lib.wicca_icon_u8, lib.wicca_icon_f32, lib.wicca_dwt_quant, lib.wicca_idwt_dequant):
        fn.restype = c_int


def library() -> ctypes.CDLL:
    """The kernel library, built on the first call of the process."""
    global _lib, build_seconds, build_log
    if _lib is not None:
        return _lib
    out_dir = BUILD_ROOT / _digest()
    so = out_dir / "libwicca_haar.so"
    if not so.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        with open(out_dir / "lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)  # one build per tree; other processes wait and reuse it
            if not so.exists():
                tmp = out_dir / f"libwicca_haar.{os.getpid()}.so"
                cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                       *(str(CSRC / s) for s in SOURCES)]
                t0 = time.perf_counter()
                res = subprocess.run(cmd, capture_output=True, text=True)
                build_seconds = time.perf_counter() - t0
                build_log = res.stdout + res.stderr
                (out_dir / "build.log").write_text(" ".join(cmd) + "\n" + build_log)
                if res.returncode != 0:
                    raise RuntimeError(f"nvcc failed ({res.returncode}):\n{build_log}")
                os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    _declare(lib)
    _lib = lib
    return lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
