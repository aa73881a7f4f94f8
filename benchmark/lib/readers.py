"""Arithmetic that several metric readers share. A reader that finds
nothing to read returns None, and the harness leaves its metric out; so
do the readers of device time where the runner's check found the trace
unsound (``Trace.unsound``)."""

from __future__ import annotations

from benchmark.lib import peaks


def device_idle_pct(run) -> float | None:
    """Share of the traced window in which no operation ran on the device."""
    t = run.trace
    if t is None or t.unsound or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def span_ms_per_mp(run, span: str) -> float | None:
    """Host milliseconds of a benchmark span per megapixel of the window's work."""
    total = run.span_total(span)
    return None if total is None or not run.units else 1e3 * total / run.units


def stage_ms_per(run, stage: str, base: str) -> float | None:
    """Milliseconds of one of the harness's ``stage_seconds`` per unit of ``base``."""
    s, n = run.counters.get(f"stage.{stage}"), run.counters.get(base)
    return None if s is None or not n else 1e3 * s / n


def kernel_roofline_pct(run, least_bytes: float, match: str = "", launched: int | None = None) -> float | None:
    """``least_bytes`` at the card's memory rate over the device time of
    the traced operations whose name contains ``match``. ``launched`` (the
    launches the program's counters saw while the trace ran; by default
    those of all its wrappers) scales the work to the operations the
    profiler recorded, which now and then are a few fewer."""
    t = run.trace
    launched = t.launches if launched is None and t is not None else launched
    if t is None or t.unsound or not least_bytes or not launched:
        return None
    seconds, recorded = t.time_of(match), t.count_of(match)
    if seconds <= 0:
        return None
    return 100.0 * least_bytes * min(1.0, recorded / launched) / peaks.hbm_bytes_per_s(run.device_name) / seconds
