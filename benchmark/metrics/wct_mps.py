"""Frame megapixels of every ``.wct`` roundtrip completed in the window
over the window's seconds."""


def read(run):
    return run.units / run.window_s if run.steps else None
