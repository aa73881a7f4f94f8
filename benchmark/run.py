"""The benchmark of ``wicca_tpu_torch`` on CUDA cards.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The cell (an entry of ``workloads`` in
``BENCHMARK.json``) names a configuration (``benchmark/configs/``) and a
traffic mix (``benchmark/traffic/<mix>.json``), which names its runner
(``benchmark/runners/<runner>.py``); each metric is read by
``benchmark/metrics/<metric>.py``. The run makes its inputs from
``--seed``, warms the cell's shapes (set-up), measures for ``--seconds``,
checks the window's answers against the plain reference
(``benchmark/reference/``) and prints one JSON line last on standard
output. With ``--trace 1`` one ``torch.profiler`` session records the
window (or its last ``trace_seconds``, where the mix sets them) and the
line carries the per-layer metrics and the trace's breakdown; where the
runner holds the trace's device times against an untraced reading and
they disagree, further slices are traced after the window, and if none
agrees the metrics of device time are left out. Set-up's first part
builds and loads the port's kernels (only the first run of a checkout
compiles); the line gives set-up's parts under ``setup_parts``. Without
a CUDA card the run fails; it never falls back to the CPU.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "benchmark" / "_cache"  # kernel caches at fixed paths inside the checkout


def _environment() -> None:
    """The program's options at their defaults; compiler caches in the checkout."""
    for key in [k for k in os.environ if k.startswith("WICCA_TPU_")]:
        del os.environ[key]
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["USE_FLAX"] = "0"


def _power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None


def _port_launches() -> int:
    """Launches the port's kernel wrappers have counted so far."""
    return sum(sum(m.LAUNCHES.values()) for name, m in list(sys.modules.items())
               if name.startswith("wicca_tpu_torch.ops.") and isinstance(getattr(m, "LAUNCHES", None), dict))


TRACE_TRIES = 3  # traced slices a run makes at most while the runner's check finds their device times unsound


def _start_trace(runner, dev):
    """A ``torch.profiler`` session (CPU and CUDA activity) with the harness's
    window range open, and CUDA events around it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from benchmark.lib import trace as tracing
    from benchmark.lib.runner import Stopwatch

    prof = profile(activities=[ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else []))
    prof.start()
    window = torch.profiler.record_function(tracing.WINDOW)
    window.__enter__()
    marks = Stopwatch(dev)
    marks.start()
    runner.tracing = True
    return prof, window, marks, _port_launches()


def _stop_trace(runner, dev, session, steps, err):
    """The session's :class:`~benchmark.lib.trace.Trace` of ``steps``."""
    from benchmark.lib import trace as tracing
    from benchmark.lib.runner import sync

    prof, window, marks, launches0 = session
    marks.stop()
    sync(dev)
    window.__exit__(None, None, None)
    prof.stop()
    runner.tracing = False
    trace = tracing.reduce(prof)
    trace.steps, trace.launches = steps, _port_launches() - launches0
    del prof
    print(f"trace: {len(trace.kernels)} device operations, {trace.launches} port launches, kinds {trace.kinds}; "
          f"window {trace.window_s:.6f} s by the host's clock, {marks.ms() / 1e3:.6f} s by the device's", file=err)
    return trace


def _timed(runner, i: int, steps: list) -> int:
    t0 = time.perf_counter()
    units = runner.step(i)
    steps.append((t0, time.perf_counter(), units))
    return i + 1


def execute(cell, t_start: float, out=None, err=None) -> int:
    """One run of ``cell`` (its seed, seconds, trace flag and device set)."""
    import copy

    import torch

    from benchmark.lib import isolation
    from benchmark.lib.cell import Run, metric_reader, runner_class
    from benchmark.lib.runner import sync

    out, err = out or sys.stdout, err or sys.stderr
    dev = torch.device(cell.device)
    runner = runner_class(cell)(cell)
    with runner.phase("build"):  # the port's kernels and libraries: built in the first run of a checkout only
        runner.build()
    runner.setup()
    print(f"setup: {json.dumps(runner.setup_parts)}", file=err)
    for record in (runner.spans, runner.counters, runner.samples):
        record.clear()  # the window's readings only
    sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    traced_for = min(float(cell.traffic.get("trace_seconds") or cell.seconds), cell.seconds)
    trace_from = cell.seconds - traced_for if cell.trace else float("inf")
    trace_until = 0.0  # a traced slice lasts its full length from the moment the profiler records
    session, first_traced, steps, i = None, 0, [], 0
    setup_s = time.perf_counter() - t_start
    w0 = time.perf_counter()
    while True:
        if session is None and time.perf_counter() - w0 >= trace_from:
            session, first_traced = _start_trace(runner, dev), i
            trace_until = time.perf_counter() + traced_for
        i = _timed(runner, i, steps)
        if steps[-1][1] - w0 >= cell.seconds and steps[-1][1] >= trace_until:
            break
    trace = None
    if session is not None:
        trace = _stop_trace(runner, dev, session, steps[first_traced:], err)
        kept = copy.deepcopy((runner.spans, runner.counters, runner.samples))
        for attempt in range(1, TRACE_TRIES + 1):
            sound, note = runner.trace_check(trace)
            if note:
                print(f"trace check: {note}{'' if sound else '; not sound'}", file=err)
            if sound:
                break
            if attempt == TRACE_TRIES:
                trace.unsound = note
                print(f"trace check: {TRACE_TRIES} slices unsound; the device-time metrics are left out", file=err)
                break
            extra, session = [], _start_trace(runner, dev)  # another slice, after the window and apart from it
            until = time.perf_counter() + traced_for
            while not extra or extra[-1][1] < until:
                i = _timed(runner, i, extra)
            trace = _stop_trace(runner, dev, session, extra, err)
        runner.spans, runner.counters, runner.samples = kept
    fifths = [0.0] * 5
    for t0, t1, u in steps:
        fifths[min(4, int(5 * (t1 - w0) / (steps[-1][1] - w0)))] += u
    span = (steps[-1][1] - w0) / 5
    print(f"window: {len(steps)} steps in {steps[-1][1] - w0:.3f} s; units/s by fifths "
          f"{[round(f / span, 3) for f in fifths]}"
          + (f"; step seconds {[round(t1 - t0, 3) for t0, t1, _ in steps]}" if len(steps) <= 40 else ""), file=err)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    runner.collect()
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    run = Run(cell=cell, setup_s=setup_s, steps=steps, spans=dict(runner.spans), counters=dict(runner.counters),
              samples=dict(runner.samples), device_name=name, trace=trace)
    metrics = {}
    for m in (cell.per_layer if cell.trace else cell.end_to_end):
        value = metric_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks, failed = runner.check()
    leaked = isolation.loaded()
    if leaked:
        print(f"isolation: the process loaded {leaked}; no result", file=err)
        return 3
    correct = bool(steps) and failed == 0 and all(c.ok for c in checks)
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type, "kind": name, "count": cell.chips,
              "memory_peak_bytes": peak}
    if dev.type == "cuda":
        device["power_limit"] = _power_limit()
    result = {"correct": correct, "attempted": len(steps), "failed": failed, "metrics": metrics, "device": device}
    if trace is not None:
        device["busy_s"], device["window_s"] = trace.busy_s, trace.window_s
        result["breakdown"] = {"device_ops": trace.device_ops, "idle_gaps": trace.idle_gaps}
    result["setup_parts"] = runner.setup_parts  # set-up's seconds by part; "build" is the kernels' build
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    for c in checks:
        print(f"check {c.name}: {c.value} (limit {c.limit}) {'ok' if c.ok else 'FAILED'}", file=err)
    err.flush()
    print(json.dumps(result), file=out, flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark.lib.cell import load

    imported = time.perf_counter()

    cell = load(args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{cell.name} needs {cell.chips} CUDA card(s); this machine has {have}. No result.", file=sys.stderr)
        return 2
    cell.seed, cell.seconds, cell.trace, cell.device = args.seed, args.seconds, bool(args.trace), "cuda:0"
    work = Path(tempfile.mkdtemp(prefix="wicca-bench-", dir=os.environ.get("TMPDIR")))
    os.environ["KERAS_HOME"] = str(work / "keras")  # no class index there: the program's fixed labels
    cell.workdir = work
    torch.cuda.init()
    print(f"setup: python and torch imports {imported - T_START:.3f} s, CUDA init {time.perf_counter() - imported:.3f} s",
          file=sys.stderr)
    try:
        return execute(cell, T_START)
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
