"""Where K6/K7's time goes on the card: build variants of
``wicca_tpu_torch/csrc/lifting_kernels.cu`` with parts of the work taken
out, and time each kernel pass at the codec's shapes.

    python3 experiments/k67_variants.py        # needs a CUDA card and nvcc
    python3 experiments/k67_variants.py --against OTHER/lifting_kernels.cu

Variants (each a text substitution on a copy of the source; the kernels of
the other sources are built unchanged):

* ``base``            the source as it is;
* ``direct``          without the rings: every row loaded straight into
                      registers when it is needed (the first version of
                      this design);
* ``nolift``          every lifting step replaced by a copy of one of its
                      inputs (the loads, the RCT, the stores and the index
                      arithmetic remain);
* ``nostore``         the stores to device memory skipped (a runtime test
                      that never holds keeps the loads and the lifting);
* ``nolift_nostore``  both: loads only.

With ``--against``, only ``base`` and ``against`` (the given source, for
example the parent commit's, with the same C interface) are built, and
their passes are timed in turns: against, base, base, against; both must
give the library's results.

Passes, on a 3x8704x6144 uint8 frame made from seed 0: K6 levels 1-3 from
uint8 with the RCT, from uint8, and from int32 (the plain RCT's output);
K7 levels 3-1 to uint8 with the inverse RCT, to uint8, and to int32.
Times: CUDA events around the wrapper's launch code, median of 20 calls.
Then each level of ``base`` alone (one launch of the C entry point between
two events, outputs allocated beforehand) with the bytes it moves and the
rate. The variants give wrong results by design; ``base`` is compared with
the library built from the unchanged sources. Prints the card's name and
power limit first.
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from wicca_tpu_torch.core.color import rct_fwd  # noqa: E402
from wicca_tpu_torch.ops import _build  # noqa: E402
from wicca_tpu_torch.ops import dwt53_cuda as d  # noqa: E402

SOURCE = "lifting_kernels.cu"


def _sub(text: str, old: str, new: str) -> str:
    if old not in text:
        raise ValueError(f"variant text not found: {old!r}")
    return text.replace(old, new)


def variants(src: str) -> dict[str, str]:
    nolift = src
    for old, new in (
        ("lift_run<F, NC>(win[q], nc0 == 0, s, d);",
         "for (int c = 0; c < NC; ++c) s[c] = win[q][2 + 2 * c], d[c] = win[q][3 + 2 * c];"),
        ("const I2 d = F::predict(e[q][c], o[q][c], e1[q][c]);", "const I2 d = o[q][c];"),
        ("const I2 s = F::update(e[q][c], dp[q][c], d);", "const I2 s = e[q][c];"),
        ("E[q][k] = F::unupdate(s0[k], dm[q][k], D[q][k]);", "E[q][k] = s0[k];"),
        ("e1[k] = F::unupdate(s1[k], D[q][k], d1[k]);", "e1[k] = s1[k];"),
        ("const I2 xo = F::unpredict(E[q][k], D[q][k], e1[k]);", "const I2 xo = D[q][k];"),
    ):
        nolift = _sub(nolift, old, new)
    nolift = nolift.replace("unlift_run<F, NC>(lo, hi, last, px[q]);",
                            "for (int e = 0; e < NC; ++e) px[q][2 * e] = lo[1 + e], px[q][2 * e + 1] = hi[1 + e];")

    def nostore(text):
        for call in ("store_row<int32_t, NC>(ll + oq", "store_row<int16_t, NC>(lh + oq",
                     "store_row<int16_t, NC>(hl + oq", "store_row<int16_t, NC>(hh + oq",
                     "store_row<uint8_t, 2 * NC>(", "store_row<int32_t, 2 * NC>("):
            text = _sub(text, call, "if (units < 0) " + call)
        return text

    direct = _sub(src, "const bool ring = Ring::ON && vec;", "const bool ring = false;")
    direct = _sub(direct, "const bool ring = Ring::ON && vec && (", "const bool ring = false && (")
    return {"base": src, "direct": direct, "nolift": nolift, "nostore": nostore(src),
            "nolift_nostore": nostore(nolift)}


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


def level_times(lib, x: torch.Tensor, st: int) -> None:
    """Each K6 and K7 level of a levels 1-3 pass alone, from the same
    library: kernel time, bytes (inputs read once, outputs written once)
    and rate."""
    dev = x.device
    c, h, w = x.shape
    xi = x.to(torch.int32)

    def grid(lvl):
        return h >> lvl, w >> lvl, 256 >> (lvl - 1), 512 >> (lvl - 1)  # hb, wb, th, tw of the frame

    def alloc(lvl):
        hb, wb, _, _ = grid(lvl)
        return (torch.empty((c, hb, wb), dtype=torch.int32, device=dev),
                [torch.empty((c, hb, wb), dtype=torch.int16, device=dev) for _ in range(3)])

    outs = {lvl: alloc(lvl) for lvl in (1, 2, 3)}

    def fwd(src, lvl, color):
        hb, wb, th, tw = grid(lvl)
        ll, bands = outs[lvl]
        rc = lib.wicca_lift_fwd_level(src.data_ptr(), int(src.dtype == torch.uint8), 0, c, src.shape[-2],
                                      src.shape[-1], hb, wb, th, tw, ll.data_ptr(), *(b.data_ptr() for b in bands),
                                      color, c, st)
        assert rc == 0, rc
        return sum(t.numel() * t.element_size() for t in (src, ll, *bands))

    def inv(lvl, out, color):
        hb, wb, th, tw = grid(lvl)
        ll, bands = outs[lvl]
        rc = lib.wicca_lift_inv_level(ll.data_ptr(), hb, wb, *(b.data_ptr() for b in bands), hb, wb, 0, c, hb, wb,
                                      th, tw, out.data_ptr(), int(out.dtype == torch.uint8), color, c, st)
        assert rc == 0, rc
        return sum(t.numel() * t.element_size() for t in (ll, *bands, out))

    rows = []
    for label, src, color in (("K6 level 1 from u8 + RCT", x, 1), ("K6 level 1 from u8", x, 0),
                              ("K6 level 1 from i32", xi, 0)):
        nb = fwd(src, 1, color)
        rows.append((label, event_ms(lambda: fwd(src, 1, color)), nb))
    for lvl in (2, 3):
        src = outs[lvl - 1][0]
        nb = fwd(src, lvl, 0)
        rows.append((f"K6 level {lvl} from i32", event_ms(lambda: fwd(src, lvl, 0)), nb))
    for lvl in (3, 2):
        out = outs[lvl - 1][0]
        nb = inv(lvl, out, 0)
        rows.append((f"K7 level {lvl} to i32", event_ms(lambda: inv(lvl, out, 0)), nb))
    for label, dtype, color in (("K7 level 1 + RCT to u8", torch.uint8, 1), ("K7 level 1 to u8", torch.uint8, 0),
                                ("K7 level 1 to i32", torch.int32, 0)):
        out = torch.empty((c, h, w), dtype=dtype, device=dev)
        nb = inv(1, out, color)
        rows.append((label, event_ms(lambda: inv(1, out, color)), nb))
    for label, ms, nb in rows:
        print(f"  {label:<26} {ms:.4f} ms  {nb / 1e6:.1f} MB  {nb / ms / 1e6:.0f} GB/s", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", type=Path, help="another lifting_kernels.cu to time in turns with this one")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k67_variants: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        src = (_build.CSRC / SOURCE).read_text()
        texts = variants(src) if args.against is None else {"against": args.against.read_text(), "base": src}
        order = list(texts) if args.against is None else ["against", "base", "base", "against"]
        jobs = {name: build(Path(tmp), name, text) for name, text in texts.items()}
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
        yuv = rct_fwd(x)
        st = torch.cuda.current_stream().cuda_stream
        filt = "legall5.3"
        ref = _build.library()
        want_ll, want_dets = d._launch_fwd(ref, x, 3, filt, st, "rct")
        want_rec = d._launch_inv(ref, want_ll, want_dets, 3, True, 3, filt, st, "rct")
        for name in order:
            lib = libs[name]
            ll, dets = d._launch_fwd(lib, x, 3, filt, st, "rct")
            ull, udets = d._launch_fwd(lib, x, 3, filt, st)
            times = {
                "K6 u8+rct": event_ms(lambda: d._launch_fwd(lib, x, 3, filt, st, "rct")),
                "K6 u8": event_ms(lambda: d._launch_fwd(lib, x, 3, filt, st)),
                "K6 i32": event_ms(lambda: d._launch_fwd(lib, yuv, 3, filt, st)),
                "K7 u8+rct": event_ms(lambda: d._launch_inv(lib, ll, dets, 3, True, 3, filt, st, "rct")),
                "K7 u8": event_ms(lambda: d._launch_inv(lib, ull, udets, 3, True, 3, filt, st)),
                "K7 i32": event_ms(lambda: d._launch_inv(lib, ull, udets, 3, False, 3, filt, st)),
            }
            note = ""
            if name in ("base", "against"):
                rec = d._launch_inv(lib, ll, dets, 3, True, 3, filt, st, "rct")
                same = torch.equal(ll, want_ll) and torch.equal(rec, want_rec) and torch.equal(rec, x)
                note = f"  equal to the library and the frame: {same}"
                if not same:
                    raise AssertionError(f"the {name} variant differs from the library built from the sources")
            print(f"{name:<16}" + "  ".join(f"{k} {v:.4f} ms" for k, v in times.items()) + note, flush=True)
        for name in dict.fromkeys(order):
            if name in ("base", "against"):
                print(f"levels of {name}, each launch alone:", flush=True)
                level_times(libs[name], x, st)
    return 0


if __name__ == "__main__":
    sys.exit(main())
