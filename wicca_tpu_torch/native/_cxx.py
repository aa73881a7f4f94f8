"""Build and load the port's host C++ libraries with g++ at first use.

Each library is built from the port's own sources into
``wicca_tpu_torch/_build/native-<hash>/``, keyed by a hash of its sources
and the compiler command and guarded by a file lock, as ``ops/_build.py``
builds the kernels: one build per tree, other processes wait and reuse it.
A library that cannot be built or loaded raises :class:`RuntimeError`
naming the command; nothing falls back.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
from pathlib import Path

BUILD_ROOT = Path(__file__).resolve().parent.parent / "_build"
CXX = "g++"
# portable code (no -march=native): a build directory may move to another host
BASE_FLAGS = ("-std=c++17", "-O3", "-fPIC", "-shared", "-Wall", "-Wextra")


def command(cxx: str, flags, sources, libs, out: Path) -> list[str]:
    """The compiler command that builds ``sources`` into ``out``."""
    return [cxx, *flags, "-o", str(out), *(str(s) for s in sources), *libs]


def build(stem: str, sources, flags, libs, cxx: str, root: Path, what: str) -> Path:
    """Build ``lib<stem>.so`` (once per sources and command) under ``root``
    and return its path; raises :class:`RuntimeError` naming the command
    when it cannot."""
    h = hashlib.sha256(" ".join(command(cxx, flags, sources, libs, Path(f"lib{stem}.so"))).encode())
    for s in sources:
        h.update(Path(s).read_bytes())
    out_dir = Path(root) / f"native-{h.hexdigest()[:16]}"
    so = out_dir / f"lib{stem}.so"
    if so.exists():
        return so
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not so.exists():
            tmp = out_dir / f"lib{stem}.{os.getpid()}.so"
            cmd = command(cxx, flags, sources, libs, tmp)
            try:
                res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
            except OSError as e:
                raise RuntimeError(f"{what} did not build: `{' '.join(cmd)}`: {e}") from None
            if res.returncode != 0:
                raise RuntimeError(f"{what} did not build: `{' '.join(cmd)}`:\n{res.stderr}")
            os.replace(tmp, so)
    return so


def open_library(so: Path, cmd: list[str], what: str) -> ctypes.CDLL:
    """Load a built library; raises naming the command that built it."""
    try:
        return ctypes.CDLL(str(so))
    except OSError as e:
        raise RuntimeError(f"{what} {so} did not load ({e}); it is built by `{' '.join(cmd)}`") from None
