"""Source megapixels x depths of every ``process_classifiers`` call
completed in the window over the calls' summed wall seconds."""


def read(run):
    return run.units / run.steps_s if run.steps else None
