"""Host milliseconds of the classifier's ``model.forward`` spans (the
forward's dispatch, summed over the classifier threads) per image
forwarded (``model.images``), both kept by the program
(``wicca_tpu_torch.utils.timing``) over the traced window; None where it
keeps neither."""


def read(run):
    from wicca_tpu_torch.utils import timing

    snapshot = getattr(timing, "snapshot", None)
    if snapshot is None:
        return None
    snap = snapshot()
    seconds, calls = snap["spans"].get("model.forward", (0.0, 0))
    images = snap["counters"].get("model.images", 0)
    return 1e3 * seconds / images if calls and images else None
