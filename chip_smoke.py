#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``wicca_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py [--seed 0] [--reps 20]

Phases, each fatal on failure:

1. the card (``nvidia-smi``), torch and CUDA versions, and the nvcc build
   of the kernels from ``wicca_tpu_torch/csrc``;
2. every kernel against its plain PyTorch twin on the same CUDA tensors
   (``torch.equal``: tolerance 0) over small shapes that cover odd sizes,
   batched input, icon depths 1-8, k = 1-3 fused levels, uint8 and float32
   input, int8 and int16 codes, non-power-of-two steps, recon offsets and
   uint8 emission;
3. the main path at full size: a 3x8704x6144 uint8 frame (bench.py's
   shape) through ``HaarCoder.get_small_copy`` (depth 5) and
   ``encode(levels=5, QuantSpec(1.0))`` -> ``decode(emit_u8=True)``, held
   equal to the plain path on the same tensors, PSNR > 30 dB, with every
   kernel's launch counter read around the run;
4. times at the main-path shapes: each kernel's device time
   (``torch.profiler``, median of ``--reps`` launches after warm-up) and its
   wrapper call, its plain twin and the yardstick library call (CUDA events,
   median of ``--reps`` calls), the depth-5 roundtrip called alone and back
   to back, then the ``kernels`` JSON line.

The last line of output is ``{"ok": true, "device": {...}}``. Without a CUDA
device the script exits non-zero before printing any result.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

H, W, LEVELS = 8704, 6144, 5
SOURCE = "wicca_tpu_torch/csrc/haar_kernels.cu"
REPLACES = {
    "icon": "wicca_tpu/ops/dwt_pallas.py:171",
    "dwt_multilevel_quant": "wicca_tpu/ops/dwt_pallas.py:405",
    "idwt_multilevel_dequant": "wicca_tpu/ops/dwt_pallas.py:498",
}
F32_PEAK = 67e12  # H100 SXM float32 outside the tensor cores, operations/s
KERNEL_SYMBOL = {"icon": "icon_", "dwt_multilevel_quant": "dwt_quant_kernel",
                 "idwt_multilevel_dequant": "idwt_dequant_kernel"}


def hbm_bytes_per_s(name: str) -> float:
    """Published device-memory rate of the card ``nvidia-smi`` names."""
    if "H200" in name:
        return 4.8e12
    if "H100" in name and "PCIe" in name:
        return 2.0e12
    if "H100" in name and "NVL" in name:
        return 3.9e12
    return 3.35e12  # H100 SXM (HBM3)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def flat(details):
    return [b for bands in details for b in bands]


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median CUDA-event time of ``fn()`` over ``reps`` runs."""
    for _ in range(warmup):
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


def loop_ms(fn, reps: int) -> float:
    """CUDA-event time per call of ``reps`` back-to-back calls of ``fn()``:
    the host enqueues the next call while the card runs this one."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int, match: str | None = None) -> float | None:
    """Median device time (ms) per call of ``fn()`` of the CUDA kernels whose
    name contains ``match`` (all kernels when None), from ``torch.profiler``;
    None when the profiler records no such kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = [e.device_time for e in prof.events()
          if e.device_type == DeviceType.CUDA and (match is None or match in e.name)]
    if len(us) < reps or len(us) % reps:
        return None
    per_call = len(us) // reps
    return statistics.median(sum(us[i * per_call : (i + 1) * per_call]) for i in range(reps)) / 1e3


def check_equal(what: str, got, want) -> None:
    if got.dtype != want.dtype or got.shape != want.shape or not torch.equal(got, want):
        diff = (got.double() - want.double()).abs().max().item() if got.shape == want.shape else None
        raise AssertionError(f"{what}: kernel {got.dtype}{tuple(got.shape)} != plain "
                             f"{want.dtype}{tuple(want.shape)}, max |diff| {diff}")


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain twin at small shapes
# ---------------------------------------------------------------------------


def phase_kernels_vs_plain(rng, dev) -> int:
    from wicca_tpu_torch.core.pad import pad_to_multiple
    from wicca_tpu_torch.ops import dwt_cuda as ops

    n = 0
    odd = torch.from_numpy(rng.integers(0, 256, (2, 3, 61, 83), dtype=np.uint8)).to(dev)
    sat = torch.zeros((1, 256, 256), dtype=torch.uint8, device=dev)
    sat[:, :, 128:] = 255
    for depth in range(1, 9):
        for mode in ("replicate", "reflect101"):
            x = pad_to_multiple(odd, 1 << depth, mode=mode).contiguous()
            check_equal(f"icon depth {depth} {mode}", ops.icon(x, depth), ops.icon_plain(x, depth))
            n += 1
        check_equal(f"icon depth {depth} saturated", ops.icon(sat, depth), ops.icon_plain(sat, depth))
        n += 1

    step_sets = {
        "int8": lambda k: tuple(1.0 for _ in range(k)),
        "int16": lambda k: tuple(0.75 for _ in range(k)),
        "hh1.5": lambda k: tuple((0.75 * 1.5**i, 0.75 * 1.5**i, 0.75 * 1.5**i * 1.5) for i in range(k)),
        "mixed": lambda k: tuple((2.5, 2.5, 3.75) if i % 2 else (0.3, 0.3, 0.45) for i in range(k)),
    }
    u8 = torch.from_numpy(rng.integers(0, 256, (2, 3, 37, 71), dtype=np.uint8)).to(dev)
    f32 = torch.from_numpy((rng.random((3, 45, 50)) * 300 - 20).astype(np.float32)).to(dev)
    for k in (1, 2, 3):
        for src_name, src in (("u8", u8), ("f32", f32)):
            x = pad_to_multiple(src, 1 << k).contiguous()
            for steps_name, make in step_sets.items():
                steps = make(k)
                what = f"k={k} {src_name} {steps_name}"
                ll, dets = ops.dwt_multilevel_quant(x, steps)
                pll, pdets = ops.dwt_multilevel_quant_plain(x, steps)
                check_equal(f"dwt {what} ll", ll, pll)
                for i, (a, b) in enumerate(zip(flat(dets), flat(pdets))):
                    check_equal(f"dwt {what} band {i}", a, b)
                n += 1
                for emit_u8 in (False, True):
                    for off in (0.5, 0.3):
                        got = ops.idwt_multilevel_dequant(ll, dets, steps, emit_u8, off)
                        want = ops.idwt_multilevel_dequant_plain(ll, dets, steps, emit_u8, off)
                        check_equal(f"idwt {what} emit_u8={emit_u8} offset={off}", got, want)
                        n += 1
    return n


# ---------------------------------------------------------------------------
# phase 3: the main path at full size
# ---------------------------------------------------------------------------


def plain_roundtrip(x, levels, spec):
    """The codec's pass structure on the plain twins: the reference the
    main path is held to (x is already a multiple of 2**levels)."""
    from wicca_tpu_torch.codec.pipeline import _pass_sizes
    from wicca_tpu_torch.ops import dwt_cuda as ops

    ll, details, lvl = x, [], 0
    for k in _pass_sizes(levels):
        ll, dets = ops.dwt_multilevel_quant_plain(ll, tuple(spec.band_steps(lvl + i + 1) for i in range(k)))
        details.extend(dets)
        lvl += k
    rec, hi = ll, levels
    for k in reversed(_pass_sizes(levels)):
        lo = hi - k
        steps = tuple(spec.band_steps(i + 1) for i in range(lo, hi))
        rec = ops.idwt_multilevel_dequant_plain(rec, details[lo:hi], steps, emit_u8=lo == 0)
        hi = lo
    return ll, details, rec


def phase_main_path(frame_np, dev):
    from wicca_tpu_torch import HaarCoder, QuantSpec, decode, encode, psnr
    from wicca_tpu_torch.ops import dwt_cuda as ops

    spec = QuantSpec(base_step=1.0)
    x = torch.from_numpy(frame_np).to(dev)

    ops.reset_launches()
    hwc_np = np.moveaxis(frame_np, 0, -1)
    icon_hwc = HaarCoder().get_small_copy(hwc_np, LEVELS, device=dev)  # numpy in, numpy out
    stream = encode(x, levels=LEVELS, spec=spec)
    rec = decode(stream, emit_u8=True)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    launches = dict(ops.LAUNCHES)
    if not all(launches.values()):
        raise AssertionError(f"a kernel of the main path never launched: {launches}")

    icon = torch.from_numpy(np.ascontiguousarray(np.moveaxis(icon_hwc, -1, 0))).to(dev)
    pll, pdets, prec = plain_roundtrip(x, LEVELS, spec)
    pairs = {
        "icon": [("main icon", icon, ops.icon_plain(x, LEVELS))],
        "dwt_multilevel_quant": [("main ll", stream.ll, pll)] + [
            (f"main band {i}", a, b) for i, (a, b) in enumerate(zip(flat(stream.details), flat(pdets)))
        ],
        "idwt_multilevel_dequant": [("main reconstruction", rec, prec)],
    }
    max_abs_err = {}
    for name, checks in pairs.items():
        for what, got, want in checks:
            check_equal(what, got, want)
        max_abs_err[name] = max((got.double() - want.double()).abs().max().item() for _, got, want in checks)
    db = float(psnr(rec, x))
    if not db > 30.0:
        raise AssertionError(f"roundtrip PSNR {db} dB <= 30")
    return x, launches, max_abs_err, db


# ---------------------------------------------------------------------------
# phase 4: times at the main-path shapes
# ---------------------------------------------------------------------------


def phase_times(x, launches, max_abs_err, reps, rate):
    from wicca_tpu_torch import HaarCoder, QuantSpec, decode, encode
    from wicca_tpu_torch.ops import dwt_cuda as ops

    spec = QuantSpec(base_step=1.0)
    s13 = tuple(spec.band_steps(i) for i in (1, 2, 3))
    s45 = tuple(spec.band_steps(i) for i in (4, 5))
    ll3, dets13 = ops.dwt_multilevel_quant(x, s13)
    ll5, dets45 = ops.dwt_multilevel_quant(ll3, s45)
    rec3 = ops.idwt_multilevel_dequant(ll5, dets45, s45)
    out = ops.idwt_multilevel_dequant(rec3, dets13, s13, emit_u8=True)
    icon = ops.icon(x, LEVELS)

    # (kernel, pass, kernel call, plain call, bytes moved, operations); bytes
    # count each input read once and each output written once; operations
    # are the arithmetic per sample the pass needs (1 add per icon input
    # byte; ~8 per forward and ~12 per inverse sample)
    n = x.numel()
    passes = [
        ("icon", "depth 5", lambda: ops.icon(x, LEVELS), lambda: ops.icon_plain(x, LEVELS),
         nbytes(x, icon), n),
        ("dwt_multilevel_quant", "levels 1-3 from u8", lambda: ops.dwt_multilevel_quant(x, s13),
         lambda: ops.dwt_multilevel_quant_plain(x, s13), nbytes(x, ll3, *flat(dets13)), 8 * n),
        ("dwt_multilevel_quant", "levels 4-5 from f32", lambda: ops.dwt_multilevel_quant(ll3, s45),
         lambda: ops.dwt_multilevel_quant_plain(ll3, s45), nbytes(ll3, ll5, *flat(dets45)), 8 * ll3.numel()),
        ("idwt_multilevel_dequant", "levels 5-4 to f32",
         lambda: ops.idwt_multilevel_dequant(ll5, dets45, s45),
         lambda: ops.idwt_multilevel_dequant_plain(ll5, dets45, s45),
         nbytes(ll5, rec3, *flat(dets45)), 12 * rec3.numel()),
        ("idwt_multilevel_dequant", "levels 3-1 to u8",
         lambda: ops.idwt_multilevel_dequant(rec3, dets13, s13, emit_u8=True),
         lambda: ops.idwt_multilevel_dequant_plain(rec3, dets13, s13, emit_u8=True),
         nbytes(rec3, out, *flat(dets13)), 12 * out.numel()),
    ]
    rows = []
    for name, label, kern, plain, b, ops_count in passes:
        call_ms = time_ms(kern, reps)  # CUDA events around the wrapper call: host + device
        ms = device_ms(kern, reps, KERNEL_SYMBOL[name])
        rows.append(dict(kernel=name, part=label, ms=call_ms if ms is None else ms,
                         timing="cuda events" if ms is None else "profiler device time", call_ms=call_ms,
                         plain_ms=time_ms(plain, max(10, reps // 2), warmup=1), bytes=b, operations=ops_count,
                         bytes_ms=b / rate * 1e3, operations_ms=ops_count / F32_PEAK * 1e3))

    library = {"icon": time_ms(lambda: torch.nn.functional.avg_pool2d(x.float(), 32), reps)}
    kernels = []
    for name in REPLACES:
        mine = [r for r in rows if r["kernel"] == name]
        bytes_ms = sum(r["bytes_ms"] for r in mine)
        ops_ms = sum(r["operations_ms"] for r in mine)
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
            "launches": launches[name], "max_abs_err": max_abs_err[name],
            "ms": sum(r["ms"] for r in mine), "plain_ms": sum(r["plain_ms"] for r in mine),
            "bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": library.get(name),
        })

    def roundtrip():
        return decode(encode(x, levels=LEVELS, spec=spec), emit_u8=True)

    mp = H * W / 1e6
    roundtrip_ms = time_ms(roundtrip, reps)
    stream_ms = loop_ms(roundtrip, reps)
    busy_ms = device_ms(roundtrip, reps)
    icon_ms = time_ms(lambda: ops.icon(x, LEVELS), reps)
    hwc = x.permute(1, 2, 0)
    coder_ms = time_ms(lambda: HaarCoder().get_small_copy(hwc, LEVELS), reps)
    e2e = {
        "roundtrip_depth5_ms": roundtrip_ms, "roundtrip_depth5_MPs": mp / roundtrip_ms * 1e3,
        "roundtrip_device_busy_ms": busy_ms,
        "roundtrip_device_idle_share": None if busy_ms is None else 1 - busy_ms / roundtrip_ms,
        "roundtrip_back_to_back_ms": stream_ms, "roundtrip_back_to_back_MPs": mp / stream_ms * 1e3,
        "back_to_back_idle_share": None if busy_ms is None else 1 - busy_ms / stream_ms,
        "icon_depth5_ms": icon_ms, "icon_depth5_MPs": mp / icon_ms * 1e3,
        "get_small_copy_hwc_tensor_ms": coder_ms,
        "roundtrip_bytes": sum(r["bytes"] for r in rows if r["kernel"] != "icon"),
    }
    return rows, kernels, e2e


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to drive", file=sys.stderr)
        return 1
    from wicca_tpu_torch.ops import _build

    # phase 1: card, versions, build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}", flush=True)
    t0 = time.perf_counter()
    _build.library()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s (nvcc {_build.build_seconds})", flush=True)
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", _build.build_log)]
    spills = sum(int(b) for b in re.findall(r"(\d+) bytes spill stores", _build.build_log))
    if regs:
        print(f"  ptxas: {len(regs)} kernels, {min(regs)}-{max(regs)} registers, {spills} bytes spill stores")
    name = torch.cuda.get_device_name(0)
    rate = hbm_bytes_per_s(name)

    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    n = phase_kernels_vs_plain(rng, torch.device("cuda"))
    print(f"phase 2: {n} kernel-vs-plain cases equal ({time.perf_counter() - t0:.1f} s)", flush=True)

    t0 = time.perf_counter()
    frame = rng.integers(0, 256, size=(3, H, W), dtype=np.uint8)
    x, launches, max_abs_err, db = phase_main_path(frame, torch.device("cuda"))
    print(f"phase 3: 3x{H}x{W} depth {LEVELS}: icon, LL, {3 * LEVELS} code planes and reconstruction equal "
          f"the plain path; PSNR {db:.4f} dB; launches {json.dumps(launches)} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    rows, kernels, e2e = phase_times(x, launches, max_abs_err, args.reps, rate)
    for r in rows:
        print(f"  {r['kernel']:<24} {r['part']:<20} {r['ms']:.4f} ms ({r['timing']}; "
              f"call {r['call_ms']:.4f} ms)  plain {r['plain_ms']:.4f} ms  {r['bytes'] / 1e6:.1f} MB  "
              f"bound {r['bytes_ms']:.4f} ms  {r['bytes'] / r['ms'] / 1e6:.0f} GB/s")
    print(json.dumps({"card": card, "hbm_bytes_per_s": rate, "passes": rows, "end_to_end": e2e}))
    print(json.dumps({"kernels": kernels}))
    device = {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
