"""Host milliseconds of ``container.serialize`` per frame megapixel."""

from benchmark.lib import readers


def read(run):
    return readers.span_ms_per_mp(run, "serialize")
