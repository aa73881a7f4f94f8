"""Build and bind the CUDA kernels of ``wicca_tpu_torch/csrc``.

The sources are compiled by ``nvcc`` at first use, one process per source,
all started together, and linked into one shared library with a plain C
interface, loaded with ctypes. The library lands in
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
SOURCES = ("haar_kernels.cu", "lifting_kernels.cu", "lifting_float_kernels.cu", "pack_kernels.cu")
HEADERS = ("launch.cuh", "haar_kernels.cuh", "lifting_kernels.cuh", "pack_kernels.cuh")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
# -fmad=false: no multiply-add contraction beyond the explicit __fmaf_rn
# calls, which sit exactly where the reference rounds a product and a sum once
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# the host build of the same sources (host_library); -ffp-contract=off as -fmad=false
HOST_FLAGS = ("-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC", "-x", "c++")

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


def _digest(flags=NVCC_FLAGS, headers=HEADERS) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for name in SOURCES + headers:
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
    lib.wicca_dwt_level.argtypes = [vp, i64, i64, i64, i64, i64, vp, vp, vp, vp, c_int, c_float, c_float, vp]
    lib.wicca_idwt_level.argtypes = [vp, vp, vp, vp, i64, i64, i64, i64, i64, c_int, c_float, vp, vp]
    lib.wicca_lift_fwd_level.argtypes = [
        vp, c_int, c_int, i64, i64, i64, i64, i64, i64, i64, vp, vp, vp, vp, c_int, c_int, vp,
    ]
    lib.wicca_lift_inv_level.argtypes = [
        vp, i64, i64, vp, vp, vp, i64, i64, c_int, i64, i64, i64, i64, i64, vp, c_int, c_int, c_int, vp,
    ]
    lib.wicca_lift97_fwd_level.argtypes = [
        vp, c_int, c_int, i64, i64, i64, i64, i64, i64, i64, vp, vp, vp, vp, c_float, c_float, c_float,
        c_int, c_int, c_float, vp,
    ]
    lib.wicca_lift97_inv_level.argtypes = [
        vp, i64, i64, vp, vp, vp, i64, i64, c_int, i64, i64, i64, i64, i64, c_float, c_float, c_float, c_float, vp,
        c_int, c_int, c_int, c_float, vp,
    ]
    pi64, pi32 = ctypes.POINTER(i64), ctypes.POINTER(ctypes.c_int32)
    lib.wicca_pack1_stats.argtypes = [c_int, pp, pi64, pi64, pi32, vp, vp]
    lib.wicca_pack1_pack.argtypes = [c_int, pp, pi64, pi64, pi32, pi32, pi32, pi32, vp, vp]
    lib.wicca_pack1_unpack.argtypes = [c_int, pp, pi64, pi64, pi64, pi64, pi32, pi32, pi32, vp, vp]
    for fn in (lib.wicca_icon_u8, lib.wicca_icon_f32, lib.wicca_dwt_quant, lib.wicca_idwt_dequant,
               lib.wicca_dwt_level, lib.wicca_idwt_level, lib.wicca_lift_fwd_level, lib.wicca_lift_inv_level,
               lib.wicca_lift97_fwd_level, lib.wicca_lift97_inv_level, lib.wicca_pack1_stats, lib.wicca_pack1_pack,
               lib.wicca_pack1_unpack):
        fn.restype = c_int


def _compile(out_dir: Path, so: Path) -> tuple[float, str]:
    """One nvcc per source, all running at once, then one link into ``so``.
    Returns the wall time and the compilers' output (also in build.log)."""
    nvcc, tag = _nvcc(), os.getpid()
    objs = [out_dir / f"{Path(s).stem}.{tag}.o" for s in SOURCES]
    cmds = [[nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(o), str(CSRC / s)] for s, o in zip(SOURCES, objs)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    tmp = out_dir / f"libwicca.{tag}.so"
    link = [nvcc, *ARCH, "-shared", "-o", str(tmp), *map(str, objs)]
    log = "".join(" ".join(c) + "\n" + o for c, o in zip(cmds, outs))
    failed = [c[-1] for c, p in zip(cmds, procs) if p.returncode != 0]
    if not failed:
        res = subprocess.run(link, capture_output=True, text=True)
        log += " ".join(link) + "\n" + res.stdout + res.stderr
        failed = [] if res.returncode == 0 else ["link"]
    (out_dir / "build.log").write_text(log)
    for o in objs:
        o.unlink(missing_ok=True)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
    os.replace(tmp, so)
    return time.perf_counter() - t0, log


def library() -> ctypes.CDLL:
    """The kernel library, built on the first call of the process."""
    global _lib, build_seconds, build_log
    if _lib is not None:
        return _lib
    out_dir = BUILD_ROOT / _digest()
    so = out_dir / "libwicca.so"
    if not so.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        with open(out_dir / "lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)  # one build per tree; other processes wait and reuse it
            if not so.exists():
                build_seconds, build_log = _compile(out_dir, so)
    lib = ctypes.CDLL(str(so))
    _declare(lib)
    _lib = lib
    return lib


def host_library(cxx: str) -> ctypes.CDLL:
    """The same sources built by the host C++ compiler ``cxx`` against
    ``csrc/host_emulation.h`` into a CPU library (the tests hold its kernels
    against the plain twins), cached as :func:`library` caches its build."""
    flags = (cxx, *HOST_FLAGS)
    out_dir = BUILD_ROOT / f"host-{_digest(flags, HEADERS + ('host_emulation.h',))}"
    so = out_dir / "libwicca_host.so"
    if not so.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        with open(out_dir / "lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not so.exists():
                tmp = out_dir / f"libwicca_host.{os.getpid()}.so"
                subprocess.run([*flags, "-I", str(CSRC), *(str(CSRC / s) for s in SOURCES), "-o", str(tmp)],
                               check=True, capture_output=True, timeout=600)
                os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    _declare(lib)
    return lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
