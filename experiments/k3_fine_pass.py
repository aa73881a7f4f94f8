"""K3's fine pass alone (levels 3-1 of a depth-5 Haar decode to uint8) on
the card, at the benchmark frame's shape, for builds of
``wicca_tpu_torch/csrc/haar_kernels.cu`` that differ in the design of
``idwt_dequant_kernel_quads``.

    python3 experiments/k3_fine_pass.py                      # needs a CUDA card and nvcc
    python3 experiments/k3_fine_pass.py --only lb0 u8q1 --against OTHER/haar_kernels.cu

Variants (each a text substitution on a copy of the source; the kernels of
the other sources are built unchanged):

* ``base``        the source as it is: a thread per tile of two level-3
                  quads (8 x 16) for uint8 output and half a quad (4 x 8) for
                  float32, blocks of 32 x 8 threads, four of them an SM for
                  uint8 from int8 codes, three for uint8 from other codes and
                  two for float32, the output stored evict-first;
* ``plainmath``   the per-pixel arithmetic as the previous kernel had it:
                  codes made float32 and the output made uint8 by the
                  conversion unit (``static_cast``, ``to_u8``), not by float
                  additions on their bits, ``bin_point``'s selects for the
                  sign, and the last multiply by 0.5 apart;
* ``plainstore``  the output stored without the evict-first hint;
* ``u8q1``, ``u8q4``, ``u8h1``  uint8 tiles of one quad (8 x 8), four
                  (8 x 32), or two half quads (4 x 16);
* ``f32h2``, ``f32q2``  float32 tiles of a whole quad (8 x 8), or two half
                  quads (4 x 16);
* ``lb0``, ``lb3``, ``lb4``  ``__launch_bounds__(256, n)`` on every instance:
                  n blocks an SM (no bound for lb0);
* ``f32mb3``, ``f32mb4``  three or four blocks an SM for float32 output;
* ``l2pf``, ``noalloc``  the codes loaded with the hint ``L2::256B`` (the L2
                  fetches 256-byte blocks) or ``L1::no_allocate``;
* ``b64x4``, ``b128x2``, ``b32x4``, ``b16x16``  other blocks of threads over
                  the tiles' columns and rows;
* ``against``     with ``--against``: another ``haar_kernels.cu`` with the
                  same C interface (the parent commit's, say).

The frame: 3x8704x6144 uint8, photograph-like from seed 0, encoded at
``QuantSpec(base_step=1.0)`` (K2 is the same in every build); the pass
reads LL3 (float32) and the int8 codes of levels 1-3 and writes the uint8
frame: 328.4 MB, whose time at the card's memory rate is the pass's byte
bound. Every build must give the plain twin's output. The builds (all, or
``base`` and those ``--only`` names, and ``against``) are timed in turns,
in order and then in reverse: the median device time of 200 launches from
``torch.profiler``, and the CUDA-event time per launch of 200 launches
queued back to back behind a spin kernel. Then, for each build, the fine
pass to float32 and with int16 codes at every level (steps 0.75), the
depth-5 coarse pass (levels 5-4), the registers of the K3 instances named
in ``SHOWN`` (``-Xptxas -v``), and the static opcode counts of the fine
pass's instance (``cuobjdump -sass``). Prints the card's name and power
limit first, then one line per reading, then one JSON line; with ``--out
DIR`` the JSON line also goes to ``DIR/k3_fine_pass.json`` and each build's
listing of that instance to ``DIR/k3_sass/<build>.sass``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from chip_smoke import hbm_bytes_per_s, photo_like  # noqa: E402
from wicca_tpu_torch import QuantSpec  # noqa: E402
from wicca_tpu_torch.ops import _build  # noqa: E402
from wicca_tpu_torch.ops import dwt_cuda as ops  # noqa: E402

SOURCE = "haar_kernels.cu"
SHAPE = (3, 8704, 6144)
REPS = 200


def _sub(text: str, old: str, new: str) -> str:
    if old not in text:
        raise ValueError(f"variant text not found: {old!r}")
    return text.replace(old, new)


LOAD_HINTED = """template <int EW>
__device__ __forceinline__ Vec<uint32_t, EW> load_hinted(const void* p) {
  Vec<uint32_t, EW> t;
  if constexpr (EW == 4)
    asm volatile("ld.global.nc.HINT.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(t.v[0]), "=r"(t.v[1]), "=r"(t.v[2]), "=r"(t.v[3]) : "l"(p));
  else if constexpr (EW == 2)
    asm volatile("ld.global.nc.HINT.v2.u32 {%0, %1}, [%2];" : "=r"(t.v[0]), "=r"(t.v[1]) : "l"(p));
  else
    asm volatile("ld.global.nc.HINT.u32 %0, [%1];" : "=r"(t.v[0]) : "l"(p));
  return t;
}

"""


def variants(src: str) -> dict[str, str]:
    plainmath = src
    for old, new in (
        ("return add_rn(bits_float(b), -8388736.0f);  // 2^23 + 2^7",
         "return static_cast<float>(static_cast<int8_t>(w[i >> 2] >> (8 * (i & 3))));"),
        ("return add_rn(bits_float(b), -8421376.0f);  // 2^23 + 2^15",
         "return static_cast<float>(static_cast<int16_t>(w[i >> 1] >> (16 * (i & 1))));"),
        ("  t = fminf(fmaxf(t, 0.0f), 510.0f);\n#if defined(__CUDA_ARCH__)",
         "  return to_u8(mul_rn(t, 0.5f));\n#if defined(__CUDA_ARCH__)"),
        ("return bin_point_int(code_float<C>(w, i), offset);", "return bin_point(code_float<C>(w, i), offset);"),
    ):
        plainmath = _sub(plainmath, old, new)
    shape = "  static constexpr int Q = EMIT_U8 ? 2 : 1;\n  static constexpr int H = EMIT_U8 ? 2 : 1;"

    def tiles(q8: int, h8: int, q32: int, h32: int) -> str:
        return _sub(src, shape, f"  static constexpr int Q = EMIT_U8 ? {q8} : {q32};\n"
                                f"  static constexpr int H = EMIT_U8 ? {h8} : {h32};")

    return {
        "base": src,
        "plainmath": plainmath,
        "plainstore": _sub(src, "  if constexpr (sizeof(t) == 16)\n    __stcs(", "  if constexpr (false)\n    __stcs("),
        "u8q1": tiles(1, 2, 1, 1),
        "u8q4": tiles(4, 2, 1, 1),
        "u8h1": tiles(2, 1, 1, 1),
        "f32h2": tiles(2, 2, 1, 2),
        "f32q2": tiles(2, 2, 2, 1),
        **{f"lb{n}": _sub(src, "__launch_bounds__(kTileBlockX * kTileBlockY, (kTileBlocksPerSm<EMIT_U8, MASK16>))",
                          f"__launch_bounds__(kTileBlockX * kTileBlockY{', ' + str(n) if n else ''})")
           for n in (0, 3, 4)},
        **{f"f32mb{n}": _sub(src, "constexpr int kTileBlocksPerSm = EMIT_U8 ? (MASK16 == 0 ? 4 : 3) : 2;",
                             f"constexpr int kTileBlocksPerSm = EMIT_U8 ? (MASK16 == 0 ? 4 : 3) : {n};")
           for n in (3, 4)},
        **{name: _sub(_sub(src, "// Read a tile's row of F * Q codes C into packed",
                           LOAD_HINTED.replace("HINT", hint) + "// Read a tile's row of F * Q codes C into packed"),
                      "const Vec<uint32_t, EW> t = *reinterpret_cast<const Vec<uint32_t, EW>*>(src + c);",
                      "const Vec<uint32_t, EW> t = load_hinted<EW>(src + c);")
           for name, hint in (("l2pf", "L2::256B"), ("noalloc", "L1::no_allocate"))},
        **{f"b{x}x{y}": _sub(src, "constexpr int kTileBlockX = 32, kTileBlockY = 8;",
                             f"constexpr int kTileBlockX = {x}, kTileBlockY = {y};")
           for x, y in ((64, 4), (128, 2), (32, 4), (16, 16))},
    }


# the fine pass's instance (uint8 out, int8 codes) in each build, mangled
FINE_SYMBOLS = ("kernel_quadsILb1ELi0ELi4E", "kernel_quadsILb1ELi0ELi2E", "kernel_quadsILb1ELi0ELi1E",
                "idwt_dequant_kernelILi3ELb1ELi0E")
FLOAT_SYMBOLS = ("kernel_quadsILb0ELi0ELi1E", "kernel_quadsILb0ELi0ELi2E", "idwt_dequant_kernelILi3ELb0ELi0E")
# the K3 instances whose registers are reported: those, and the new kernel's
# float32 output, int16 codes and column-by-column instances
SHOWN = FINE_SYMBOLS + tuple(f"quadsIL{o}ELi{m}ELi{v}E" for o, m, v in (
    ("b0", 0, 1), ("b0", 0, 2), ("b1", 7, 4), ("b1", 7, 2), ("b1", 7, 1))) + ("idwt_dequant_kernelILi3ELb0ELi0E",)


def sass_opcodes(so: Path, name: str, out: Path | None) -> dict:
    """Static opcode counts of the fine pass's kernel in ``so``; its listing
    goes to ``out/k3_sass/<name>.sass`` where ``out`` is given."""
    tool = Path(_build._nvcc()).with_name("cuobjdump")
    res = subprocess.run([str(tool), "-sass", str(so)], capture_output=True, text=True)
    if res.returncode != 0:
        return {"error": res.stderr[-300:]}
    counts, inside, kept = {}, False, []
    for line in res.stdout.splitlines():
        if "Function :" in line:
            inside = any(sym in line for sym in FINE_SYMBOLS)
        if inside:
            kept.append(line)
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if inside and m:
            op = m.group(1).split(".")[0]
            counts[op] = counts.get(op, 0) + 1
    if out is not None:
        (out / "k3_sass").mkdir(parents=True, exist_ok=True)
        (out / "k3_sass" / f"{name}.sass").write_text("\n".join(kept) + "\n")
    top = dict(sorted(counts.items(), key=lambda kv: -kv[1])[:24])
    return {"total": sum(counts.values()), "top": top}


def _nvcc_job(src: Path, obj: Path) -> subprocess.Popen:
    return subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-c", "-o", str(obj),
                             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def build(out: Path, name: str, text: str):
    """Start the nvcc process of one variant's ``haar_kernels.cu``; returns
    (process, object, library path)."""
    vdir = out / name
    vdir.mkdir()
    (vdir / SOURCE).write_text(text)
    obj = vdir / "haar_kernels.o"
    return _nvcc_job(vdir / SOURCE, obj), obj, vdir / "lib.so"


def registers(log: str) -> dict[str, int]:
    """Registers per K3 instance, from ptxas's report (demangled names cut)."""
    regs, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line) or re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and fn and "idwt_dequant_kernel" in fn:
            regs[fn] = int(m.group(1))
    return regs


class Pass:
    """One K3 launch through a library's C entry point, output preallocated."""

    def __init__(self, lib, ll, dets, steps, emit_u8: bool):
        self.lib, self.ll, self.dets = lib, ll, dets
        self.p = ops.IdwtPass(ll.shape, [b[0].dtype for b in dets], steps, emit_u8, 0.5)
        self.ptrs = (ctypes.c_void_p * 9)(*(b.data_ptr() for bands in dets for b in bands))
        self.out = torch.empty(self.p.out_shape, dtype=self.p.out_dtype, device=ll.device)
        self.stream = torch.cuda.current_stream().cuda_stream

    def __call__(self):
        p = self.p
        rc = self.lib.wicca_idwt_dequant(self.ll.data_ptr(), self.ptrs, p.is16, p.steps, p.offset, p.k, p.planes, p.ch,
                                         p.cw, self.out.data_ptr(), p.u8, self.stream)
        assert rc == 0, rc
        return self.out

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (self.ll, self.out, *(b for bs in self.dets for b in bs)))


def device_ms(fn, reps: int = REPS) -> float:
    """Median kernel time from torch.profiler over ``reps`` launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = [e.device_time for e in prof.events() if e.device_type == DeviceType.CUDA]
    return statistics.median(us) / 1e3 if us else float("nan")


def queued_ms(fn, reps: int = REPS) -> float:
    """CUDA-event time per launch of ``reps`` launches queued behind a spin."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)  # the host queues every launch while the card spins
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", type=Path, help="another haar_kernels.cu to time with this one's variants")
    ap.add_argument("--only", nargs="+", help="build and time these variants only (base always)")
    ap.add_argument("--out", type=Path, help="directory for the JSON line and the SASS listings")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k3_fine_pass: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    rate = hbm_bytes_per_s(card.split(",")[0])
    result = {"card": card, "passes": {}, "registers": {}}
    with tempfile.TemporaryDirectory() as tmp:
        src = (_build.CSRC / SOURCE).read_text()
        texts = {k: v for k, v in variants(src).items() if args.only is None or k in args.only or k == "base"}
        if args.against is not None:
            texts["against"] = args.against.read_text()
        t0 = time.perf_counter()
        shared = [(_build.CSRC / src, Path(tmp) / (Path(src).stem + ".o")) for src in _build.SOURCES if src != SOURCE]
        shared_jobs = [_nvcc_job(src, obj) for src, obj in shared]
        jobs = {name: build(Path(tmp), name, text) for name, text in texts.items()}
        for job in shared_jobs:
            log = job.communicate()[0]
            if job.returncode:
                raise RuntimeError(f"nvcc failed\n{log[-3000:]}")
        libs = {}
        for name, (proc, obj, so) in jobs.items():
            log = proc.communicate()[0]
            if proc.returncode:
                errors = "\n".join(line for line in log.splitlines() if "error" in line)
                raise RuntimeError(f"{name}: nvcc failed\n{errors[:3000]}")
            subprocess.run([_build._nvcc(), *_build.ARCH, "-shared", "-o", str(so), str(obj),
                            *(str(o) for _, o in shared)], check=True)
            lib = ctypes.CDLL(str(so))
            _build._declare(lib)
            libs[name] = lib
            result["registers"][name] = {k: v for k, v in registers(log).items() if any(t in k for t in SHOWN)}
            result.setdefault("sass", {})[name] = sass_opcodes(so, name, args.out)
        result["build_s"] = time.perf_counter() - t0
        print(f"built {len(texts)} variants of {SOURCE} at once in {result['build_s']:.1f} s", flush=True)

        dev = torch.device("cuda")
        x = torch.from_numpy(photo_like(SHAPE, 0)).to(dev)
        st = torch.cuda.current_stream().cuda_stream
        ref = libs["base"]
        spec = QuantSpec(base_step=1.0)
        s13 = ops._band_steps3(tuple(spec.band_steps(i) for i in (1, 2, 3)))
        s45 = ops._band_steps3(tuple(spec.band_steps(i) for i in (4, 5)))
        ll3, d13 = ops._launch_dwt(ref, x, s13, st)
        ll5, d45 = ops._launch_dwt(ref, ll3, s45, st)
        rec3 = ops._launch_idwt(ref, ll5, d45, s45, False, 0.5, st)
        want = ops.idwt_multilevel_dequant_plain(rec3, d13, s13, emit_u8=True)
        s16 = ((0.75,) * 3,) * 3
        ll3w, d13w = ops._launch_dwt(ref, x, s16, st)

        fine = {name: Pass(lib, rec3, d13, s13, True) for name, lib in libs.items()}
        nbytes = fine["base"].nbytes()
        for name, p in fine.items():
            if not torch.equal(p(), want):
                raise AssertionError(f"the {name} build's fine pass differs from the plain twin")
        order = list(fine) + list(reversed(fine))
        times = {name: {"profiler_ms": [], "queued_ms": []} for name in fine}
        for name in order:
            times[name]["profiler_ms"].append(device_ms(fine[name]))
            times[name]["queued_ms"].append(queued_ms(fine[name]))
        bound_ms = nbytes / rate * 1e3
        print(f"fine pass to uint8: {nbytes / 1e6:.1f} MB, bound {bound_ms:.4f} ms at {rate / 1e12:.2f} TB/s",
              flush=True)
        for name, t in times.items():
            ms = statistics.median(t["profiler_ms"])
            print(f"  {name:<11} profiler {' '.join(f'{v:.4f}' for v in t['profiler_ms'])} ms, queued "
                  f"{' '.join(f'{v:.4f}' for v in t['queued_ms'])} ms: {100 * bound_ms / ms:.1f}% of the bound",
                  flush=True)
            result["passes"][name] = {"fine_u8": {**t, "bound_ms": bound_ms, "pct_of_bound": 100 * bound_ms / ms}}

        for name in libs:
            lib = libs[name]
            others = {
                "fine_f32": Pass(lib, rec3, d13, s13, False),
                "fine_u8_int16": Pass(lib, ll3w, d13w, s16, True),
                "coarse_f32": Pass(lib, ll5, d45, s45, False),
            }
            for label, p in others.items():
                ms = device_ms(p)
                b = p.nbytes()
                print(f"  {name:<11} {label:<14} {ms:.4f} ms, {b / 1e6:.1f} MB: {100 * b / rate / ms / 1e-3:.1f}% of "
                      "the bound", flush=True)
                result["passes"][name][label] = {"profiler_ms": ms, "bound_ms": b / rate * 1e3}
            out = others["fine_f32"]()
            if not torch.equal(out, ops.idwt_multilevel_dequant_plain(rec3, d13, s13)):
                raise AssertionError(f"the {name} build's fine pass to float32 differs from the plain twin")
        for name, regs in result["registers"].items():
            print(f"  registers {name}: {json.dumps(regs)}", flush=True)
        for name, ops_ in result["sass"].items():
            print(f"  sass {name}: {json.dumps(ops_)}", flush=True)
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / "k3_fine_pass.json").write_text(json.dumps(result) + "\n")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
