"""The share of ``encode`` and ``decode`` calls that found the launch plan
of their geometry already built, from the program's counters
``codec.plan_hit`` and ``codec.plan_miss`` (``wicca_tpu_torch.utils.timing``)
over the traced intervals: hits / (hits + misses); None where the program
counted neither."""


def read(run):
    from wicca_tpu_torch.utils import timing

    snapshot = getattr(timing, "snapshot", None)
    counters = snapshot()["counters"] if snapshot else {}
    hits, misses = counters.get("codec.plan_hit", 0), counters.get("codec.plan_miss", 0)
    return hits / (hits + misses) if hits + misses else None
