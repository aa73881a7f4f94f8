"""Frame megapixels of every roundtrip completed in the window over the
window's seconds (first call to last result)."""


def read(run):
    return run.units / run.window_s if run.steps else None
