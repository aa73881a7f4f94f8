"""Where K8/K9's time goes on the card: build variants of
``wicca_tpu_torch/csrc/lifting_float_kernels.cu`` with parts of the work
taken out, and time each kernel pass at the codec's shapes.

    python3 experiments/k89_variants.py        # needs a CUDA card and nvcc

Variants (each a text substitution on a copy of the source; the kernels of
the other sources are built unchanged):

* ``base``            the source as it is;
* ``nolift``          every lifting run replaced by a copy (loads, staging,
                      shared-memory passes, barriers and stores remain);
* ``nolift_nostage``  ``nolift`` without the cp.async copies;
* ``nolift_nostore``  ``nolift`` without the stores to device memory.

Passes, on a 3x8704x6144 uint8 frame made from seed 0, ``QuantSpec(1.0)``:
K8 levels 1-3 from uint8 with the ICT (``chroma_gain`` 2), from uint8, and
from float32; K9 levels 3-1 to uint8 with the inverse ICT, to uint8, and to
float32. Times: CUDA events around the wrapper's launch code, median of 20
calls. The variants without lifting give wrong results by design; ``base``
is compared with the library built from the unchanged sources. Prints the
card's name and power limit first.
"""

from __future__ import annotations

import ctypes
import re
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from wicca_tpu_torch import QuantSpec  # noqa: E402
from wicca_tpu_torch.ops import _build  # noqa: E402
from wicca_tpu_torch.ops import dwt97_cuda as d  # noqa: E402

SOURCE = "lifting_float_kernels.cu"


def _sub(text: str, old: str, new: str) -> str:
    if old not in text:
        raise ValueError(f"variant text not found: {old!r}")
    return text.replace(old, new)


def variants(src: str) -> dict[str, str]:
    nolift = re.sub(r"fwd_run<F>\(win, [^;]*, lo, hi\);",
                    "for (int v = 0; v < kRun; ++v) lo[v] = win[2 * v], hi[v] = win[2 * v + 1];", src)
    nolift = re.sub(r"inv_run<F>\(s, d, [^;]*, xs\);",
                    "for (int v = 0; v < kRun; ++v) xs[2 * v] = s[v], xs[2 * v + 1] = d[v];", nolift)
    nostore = nolift
    for call in ("store_part<float, 8>(ll + o", "store_part<int16_t, 8>(lh + o", "store_part<int16_t, 8>(hl + o",
                 "store_part<int16_t, 8>(hh + o", "store_part<Out, GO>("):
        nostore = _sub(nostore, call, "if (n == -7) " + call)
    return {
        "base": src,
        "nolift": nolift,
        "nolift_nostage": _sub(nolift, "    copy_async<16>(d, row + lo);",
                               "    if (lo == -12345) copy_async<16>(d, row + lo);"),
        "nolift_nostore": nostore,
    }


def build(out: Path, name: str, text: str):
    """Start the nvcc processes of one variant; returns (processes, objects, library path)."""
    vdir = out / name
    vdir.mkdir()
    (vdir / SOURCE).write_text(text)
    procs, objs = [], []
    for src in _build.SOURCES:
        path = vdir / src if src == SOURCE else _build.CSRC / src
        obj = vdir / (Path(src).stem + ".o")
        objs.append(obj)
        procs.append(subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-c", "-o",
                                       str(obj), str(path)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    return procs, objs, vdir / "lib.so"


def event_ms(fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> int:
    if not torch.cuda.is_available():
        print("k89_variants: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        jobs = {name: build(Path(tmp), name, text)
                for name, text in variants((_build.CSRC / SOURCE).read_text()).items()}
        libs = {}
        for name, (procs, objs, so) in jobs.items():
            logs = "".join(p.communicate()[0] for p in procs)
            if any(p.returncode for p in procs):
                raise RuntimeError(f"{name}: nvcc failed\n{logs[-3000:]}")
            subprocess.run([_build._nvcc(), *_build.ARCH, "-shared", "-o", str(so), *map(str, objs)], check=True)
            lib = ctypes.CDLL(str(so))
            _build._declare(lib)
            libs[name] = lib

        dev = torch.device("cuda")
        x = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (3, 8704, 6144), dtype=np.uint8)).to(dev)
        xf = x.float()
        spec = QuantSpec(base_step=1.0)
        s13 = d._band_steps3(tuple(spec.band_steps(i) for i in (1, 2, 3)))
        st = torch.cuda.current_stream().cuda_stream
        ref = _build.library()
        want_ll, want_dets = d._launch_fwd(ref, x, s13, "cdf97", st, "ict", 2.0)
        want_rec = d._launch_inv(ref, want_ll, want_dets, s13, True, 3, "cdf97", 0.5, st, "ict", 2.0)
        for name, lib in libs.items():
            ll, dets = d._launch_fwd(lib, x, s13, "cdf97", st, "ict", 2.0)
            ull, udets = d._launch_fwd(lib, x, s13, "cdf97", st)
            times = {
                "K8 u8+ict": event_ms(lambda: d._launch_fwd(lib, x, s13, "cdf97", st, "ict", 2.0)),
                "K8 u8": event_ms(lambda: d._launch_fwd(lib, x, s13, "cdf97", st)),
                "K8 f32": event_ms(lambda: d._launch_fwd(lib, xf, s13, "cdf97", st)),
                "K9 u8+ict": event_ms(lambda: d._launch_inv(lib, ll, dets, s13, True, 3, "cdf97", 0.5, st, "ict", 2.0)),
                "K9 u8": event_ms(lambda: d._launch_inv(lib, ull, udets, s13, True, 3, "cdf97", 0.5, st)),
                "K9 f32": event_ms(lambda: d._launch_inv(lib, ull, udets, s13, False, 3, "cdf97", 0.5, st)),
            }
            note = ""
            if name == "base":
                rec = d._launch_inv(lib, ll, dets, s13, True, 3, "cdf97", 0.5, st, "ict", 2.0)
                same = torch.equal(ll, want_ll) and torch.equal(rec, want_rec)
                note = f"  equal to the library: {same}"
                if not same:
                    raise AssertionError("the base variant differs from the library built from the sources")
            print(f"{name:<16}" + "  ".join(f"{k} {v:.4f} ms" for k, v in times.items()) + note, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
