"""Operations of the forwards in the traced calls (2 x the multiply-adds of
every product, from the shapes: the runner's ``forward_flops`` per call)
over the device time of every traced operation that is not a copy, a set
or the icon kernel K1 (``classify.forward_device_s``), at the card's dense
bfloat16 peak: the forwards' share of their roofline, whatever kernels
implement them. None where the trace is absent or the runner's check found
it unsound."""

from benchmark.lib import peaks


def read(run):
    from benchmark.runners.classify import forward_device_s

    t = run.trace
    if t is None or t.unsound or not t.steps:
        return None
    calls, flops = run.counters.get("calls"), run.counters.get("forward_flops")
    seconds = forward_device_s(t)
    if not calls or not flops or seconds <= 0:
        return None
    return 100.0 * flops / calls * len(t.steps) / seconds / peaks.bf16_flops_per_s(run.device_name)
