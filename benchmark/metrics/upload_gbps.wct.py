"""GB/s of the link upward: the bytes the program handed from host memory to
the card (``link.up_bytes``, ``wicca_tpu_torch.utils.timing``) over the
device time of the traced host-to-device copies (``Memcpy HtoD``). In this
cell every such copy is the program's. None where the program keeps no
such counter, or the trace is absent, unsound or holds no such copy."""


def read(run):
    from wicca_tpu_torch.utils import timing

    snapshot = getattr(timing, "snapshot", None)
    t = run.trace
    if snapshot is None or t is None or t.unsound:
        return None
    up, seconds = snapshot()["counters"].get("link.up_bytes", 0), t.time_of("Memcpy HtoD")
    return up / 1e9 / seconds if up and seconds > 0 else None
