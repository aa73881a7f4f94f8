"""The reduction of one ``torch.profiler`` session (CPU and CUDA activity)
to what the traced run reports: the device's busy seconds over the traced
window (intervals of every stream merged), the device operations that
took most time, and the idle gaps, split over the innermost host activity
(a ``bench.*`` range or a PyTorch op, on any thread) at each instant."""
from __future__ import annotations

import heapq
import sys
from collections import Counter, defaultdict
from dataclasses import dataclass

WINDOW = "bench.window"  # the range the harness holds open over the traced steps


@dataclass
class Trace:
    window_s: float
    busy_s: float
    kernels: list  # (name, start_ns, end_ns) of every device operation, clipped to the window
    device_ops: list  # [[name, seconds]], the 10 that took most time
    idle_gaps: list  # [[host activity, seconds]], the 10 that left the device idle longest
    kinds: dict  # device type -> events recorded, for the record
    steps: list = None  # the harness's (start, end, units) of the traced steps
    launches: int = 0  # launches the port's wrappers counted while the trace ran
    unsound: str = ""  # why the runner's check does not trust the device times, where it does not

    def time_of(self, match: str) -> float:
        """Device seconds of the operations whose name contains ``match``."""
        return sum(e - s for n, s, e in self.kernels if match in n) / 1e9

    def count_of(self, match: str) -> int:
        return sum(1 for n, _, _ in self.kernels if match in n)


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _top(totals: dict, n: int = 10) -> list:
    return [[name, ns / 1e9] for name, ns in sorted(totals.items(), key=lambda kv: -kv[1])[:n]]


def _name_gaps(gaps, cpu) -> dict:
    """Idle ns per host activity: each gap split over the innermost host
    event (the shortest one open, on any thread) at each instant."""
    points = sorted({p for s, e, _ in cpu for p in (s, e)})
    cpu = sorted(cpu)
    active: list = []  # heap of (duration, end, name) of events that have started
    segments = []  # (start, end, name) where the innermost event does not change
    i = 0
    for a, b in zip(points, points[1:]):
        while i < len(cpu) and cpu[i][0] <= a:
            s, e, name = cpu[i]
            heapq.heappush(active, (e - s, e, name))
            i += 1
        while active and active[0][1] <= a:
            heapq.heappop(active)
        if active:
            if segments and segments[-1][2] == active[0][2] and segments[-1][1] == a:
                segments[-1][1] = b
            else:
                segments.append([a, b, active[0][2]])
    totals: dict = defaultdict(int)
    j = 0
    for s, e in gaps:
        covered = 0
        while j < len(segments) and segments[j][1] <= s:
            j += 1
        k = j
        while k < len(segments) and segments[k][0] < e:
            lap = min(e, segments[k][1]) - max(s, segments[k][0])
            if lap > 0:
                totals[segments[k][2]] += lap
                covered += lap
            k += 1
        if e - s > covered:
            totals["host: outside any recorded op"] += e - s - covered
    return totals


def reduce(prof) -> Trace:
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    windows = [e for e in events if e.name() == WINDOW and e.device_type() == DeviceType.CPU]
    if not windows:
        raise RuntimeError(f"the trace holds no {WINDOW} range")
    t0 = windows[0].start_ns()
    t1 = t0 + windows[0].duration_ns()
    kinds: Counter = Counter()
    dev, cpu, raw = [], [], []
    for e in events:
        kind = e.device_type()
        kinds[kind.name] += 1
        s = e.start_ns()
        end = s + e.duration_ns()
        if kind == DeviceType.CUDA:
            if e.is_user_annotation():
                continue
            raw.append((s, end))
            s, end = max(s, t0), min(end, t1)
            if end > s:
                dev.append((e.name()[:160], s, end))
        elif kind == DeviceType.CPU and e.name() != WINDOW and end > t0 and s < t1:
            cpu.append((s, end, e.name()[:160]))
    merged = _merge((s, e) for _, s, e in dev)
    busy = sum(e - s for s, e in merged)
    gaps, cur = [], t0
    for s, e in merged:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if cur < t1:
        gaps.append((cur, t1))
    by_op: dict = defaultdict(int)
    for n, s, e in dev:
        by_op[n] += e - s
    if raw:  # where the device's clock and the host's part, the trace is not to be trusted
        first, last = min(r[0] for r in raw), max(r[1] for r in raw)
        print(f"trace check: device operations from {(first - t0) / 1e9:+.6f} s to {(last - t1) / 1e9:+.6f} s of "
              f"the window's ends, spanning {(last - first) / 1e9:.6f} s", file=sys.stderr)
    return Trace(window_s=(t1 - t0) / 1e9, busy_s=busy / 1e9, kernels=dev, device_ops=_top(by_op),
                 idle_gaps=_top(_name_gaps(gaps, cpu)), kinds=dict(kinds))


