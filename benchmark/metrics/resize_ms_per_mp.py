"""The harness's ``stage_seconds.resize`` (cv2 resizes, summed over the
classifier threads) per source megapixel x depth."""

from benchmark.lib import readers


def read(run):
    return readers.stage_ms_per(run, "resize", "source_mp")
