"""The harness's ``stage_seconds.inference`` (the classifier calls: upload,
forward, logits back) per image forwarded."""

from benchmark.lib import readers


def read(run):
    return readers.stage_ms_per(run, "inference", "forwards")
