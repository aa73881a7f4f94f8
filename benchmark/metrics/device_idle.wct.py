"""Share of the traced window in which no operation ran on the card
(device intervals of every stream merged)."""

from benchmark.lib import readers


def read(run):
    return readers.device_idle_pct(run)
