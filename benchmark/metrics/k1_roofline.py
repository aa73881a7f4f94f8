"""The icons' least bytes (every source plane read once per depth, every
icon written once) at the card's memory rate, over the device time of the
icon kernel K1 (device symbol ``icon_``) in the traced window. The traced
window is the whole window here, so the counters cover the same calls; the
wrapper's launch counter scales the work to the launches the profiler recorded."""

from benchmark.lib import readers

KERNEL = "icon_"


def read(run):
    t = run.trace
    if t is None or not t.count_of(KERNEL) or len(t.steps) != len(run.steps):
        return None
    return readers.kernel_roofline_pct(run, run.counters.get("icon_bytes", 0), KERNEL,
                                       int(run.counters.get("k1_launches", 0)))
