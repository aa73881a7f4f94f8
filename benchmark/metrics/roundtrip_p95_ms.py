"""95th percentile of every roundtrip of the window, each from the call
to its last kernel's end by CUDA events on the stream (the runner's
``roundtrip_ms`` samples; numpy's linear interpolation)."""

import numpy as np


def read(run):
    times = run.samples.get("roundtrip_ms")
    return float(np.percentile(times, 95)) if times else None
