"""Where the card idles inside a depth-5 Haar roundtrip (``encode`` ->
``decode(emit_u8=True)`` of a 3x8704x6144 uint8 frame, one in flight,
synchronized after each), through the codec's launch plans and through its
per-pass code (the plans switched off), in a bare loop and in a loop shaped
like the benchmark's resident cell (CUDA events recorded around the call,
the synchronize, the events read).

    python3 experiments/haar_roundtrip_gaps.py   # on a CUDA card

Prints one JSON line: for each path and loop, the host milliseconds from
the call to its return and the wall milliseconds to the synchronized end
(medians of 400 roundtrips, no profiler); then, from a CUDA-only profiler
session over 300 roundtrips, the medians of each kernel's time and of each
gap between the four kernels of a roundtrip: ``before`` (the previous
roundtrip's last kernel to K2's fine pass), ``k2`` (K2's fine pass to its
coarse pass), ``k2_k3`` (K2's coarse pass to K3's coarse pass) and ``k3``
(K3's coarse pass to its fine pass), in microseconds. The session adds its
own cost to every launch (on an H100's host a profiled roundtrip read 0.47
ms of kernels and gaps where the unprofiled one took 0.35), so its gaps are
upper bounds and show where the host is late, not by how much.
"""

import json
import os
import statistics
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from wicca_tpu_torch import QuantSpec, decode, encode  # noqa: E402
from wicca_tpu_torch.codec import pipeline  # noqa: E402

SPEC = QuantSpec(base_step=1.0)
KERNELS = ("dwt_quant_kernel<3", "dwt_quant_kernel<2", "idwt_dequant_kernel<2", "idwt_dequant_kernel<3")
GAPS = ("before", "k2", "k2_k3", "k3")


def _loop(x, n: int, bench_like: bool):
    """``n`` roundtrips; host and wall milliseconds of each."""
    dev = x.device
    marks = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
    host, wall, held = [], [], None
    for _ in range(n):
        t0 = time.perf_counter()
        if bench_like:
            marks[0].record()
        stream = encode(x, levels=5, spec=SPEC)
        rec = decode(stream, emit_u8=True)
        if bench_like:
            marks[1].record()
        t1 = time.perf_counter()
        torch.cuda.synchronize(dev)
        if bench_like:
            marks[0].elapsed_time(marks[1])
        wall.append(1e3 * (time.perf_counter() - t0))
        host.append(1e3 * (t1 - t0))
        held = (stream, rec)  # the last result stays held, as the benchmark holds it
    del held
    return host, wall


def _gaps(x, n: int, bench_like: bool) -> dict:
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _loop(x, n, bench_like)
    kernels = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                     for e in prof.profiler.kineto_results.events() if any(k in e.name() for k in KERNELS))
    times = {k: [] for k in KERNELS}
    gaps = {g: [] for g in GAPS}
    prev_end = None
    for i in range(0, len(kernels) - 3, 4):
        group = kernels[i : i + 4]
        if [next(k for k in KERNELS if k in name) for _, _, name in group] != list(KERNELS):
            return {"error": f"unexpected kernel order at {i}: {[name[:40] for _, _, name in group]}"}
        for (s, e, _), k in zip(group, KERNELS):
            times[k].append((e - s) / 1e3)
        if prev_end is not None:
            gaps["before"].append((group[0][0] - prev_end) / 1e3)
        for (_, e, _), (s, _, _), g in zip(group, group[1:], GAPS[1:]):
            gaps[g].append((s - e) / 1e3)
        prev_end = group[3][1]
    return {"roundtrips": len(kernels) // 4,
            "kernel_us": {k: round(statistics.median(v), 2) for k, v in times.items()},
            "gap_us": {g: round(statistics.median(v), 2) for g, v in gaps.items()},
            "gap_p90_us": {g: round(statistics.quantiles(v, n=10)[-1], 2) for g, v in gaps.items()}}


def main() -> None:
    dev = torch.device("cuda", 0)
    x = torch.randint(0, 256, (3, 8704, 6144), dtype=torch.uint8, device=dev,
                      generator=torch.Generator(device=dev).manual_seed(5))
    out = {"device": torch.cuda.get_device_name(dev), "torch": torch.__version__}
    launch = pipeline._PLAN_LAUNCH["cuda"]
    for path in ("plans", "pass_code", "plans_again"):
        if path == "pass_code":
            del pipeline._PLAN_LAUNCH["cuda"]
        else:
            pipeline._PLAN_LAUNCH["cuda"] = launch
        for bench_like in (False, True):
            _loop(x, 40, bench_like)  # warm: the plans, the allocator's blocks
            host, wall = _loop(x, 400, bench_like)
            out[f"{path}.{'bench' if bench_like else 'bare'}"] = {
                "host_ms": round(statistics.median(host), 4), "wall_ms": round(statistics.median(wall), 4),
                **_gaps(x, 300, bench_like)}
    pipeline._PLAN_LAUNCH["cuda"] = launch
    print(json.dumps(out))


if __name__ == "__main__":
    main()
