"""The roundtrips' least bytes (frame read once, stream written and read
once, reconstruction written once) at the card's memory rate, over the
summed device time of every operation in the traced slice."""

from benchmark.lib import counts, readers


def read(run):
    t, cfg = run.trace, run.cell.config
    if t is None or not t.steps:
        return None
    c, h, w = cfg["frame"]
    least = counts.haar_roundtrip_bytes(c, h, w, cfg["levels"]) * len(t.steps)
    return readers.kernel_roofline_pct(run, least)
