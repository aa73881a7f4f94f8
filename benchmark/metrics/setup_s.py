"""Process start to the first timed call: imports, inputs, loading, warm-up
and, in the first run of a checkout, the kernels' build."""


def read(run):
    return run.setup_s
