"""Forward operations of every image forwarded in the window (2 x the
multiply-adds of every layer, from the shapes) over the calls' seconds at
the card's dense bfloat16 peak."""

from benchmark.lib import peaks


def read(run):
    flops = run.counters.get("forward_flops")
    if not flops or not run.steps:
        return None
    return 100.0 * flops / (run.steps_s * peaks.bf16_flops_per_s(run.device_name))
