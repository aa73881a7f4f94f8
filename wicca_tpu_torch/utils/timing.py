"""Timing and profiling helpers (counterpart of ``wicca_tpu/utils/timing.py``).

``StageTimer`` collects wall time per named stage (the harness's
``run-metrics.json``); ``format_proc_time`` formats a duration; ``trace``
records a ``torch.profiler`` trace of host and CUDA work (a Chrome trace
JSON, viewed in Perfetto).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from pathlib import Path


def format_proc_time(seconds: float) -> str:
    """Human-readable duration, e.g. ``1 h 2 min 5 sec``."""
    seconds = int(round(seconds))
    h, rem = divmod(seconds, 3600)
    m, s = divmod(rem, 60)
    parts = []
    if h:
        parts.append(f"{h} h")
    if m:
        parts.append(f"{m} min")
    if s or not parts:
        parts.append(f"{s} sec")
    return " ".join(parts)


class StageTimer:
    """Accumulates wall time per named stage; totals() for structured logs."""

    def __init__(self):
        self._acc: dict[str, float] = defaultdict(float)
        self._count: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._acc[name] += time.perf_counter() - t0
            self._count[name] += 1

    def totals(self) -> dict[str, float]:
        return dict(self._acc)

    def report(self) -> str:
        total = sum(self._acc.values()) or 1e-12
        lines = [
            f"{name:>20}: {t:8.3f}s ({100 * t / total:5.1f}%) x{self._count[name]}"
            for name, t in sorted(self._acc.items(), key=lambda kv: -kv[1])
        ]
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str | Path = "wicca_trace"):
    """``torch.profiler`` over the block (CPU, and CUDA where a card is
    present); writes ``<log_dir>/trace.json`` (Chrome trace format) at the
    end and yields the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))
