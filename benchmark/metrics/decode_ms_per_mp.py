"""The harness's ``stage_seconds.decode`` (waiting on the decode pool) per
source megapixel x depth."""

from benchmark.lib import readers


def read(run):
    return readers.stage_ms_per(run, "decode", "source_mp")
