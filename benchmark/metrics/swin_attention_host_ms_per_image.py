"""Host milliseconds of the Swin blocks' window attention (the program's
``model.swin.attention`` spans: shift, partition, bias, mask, softmax and
reverse, dispatched on the classifier threads) per image forwarded
(``model.images``), both kept by the program
(``wicca_tpu_torch.utils.timing``) over the traced window; None where it
keeps neither."""


def read(run):
    from wicca_tpu_torch.utils import timing

    snapshot = getattr(timing, "snapshot", None)
    if snapshot is None:
        return None
    snap = snapshot()
    seconds, calls = snap["spans"].get("model.swin.attention", (0.0, 0))
    images = snap["counters"].get("model.images", 0)
    return 1e3 * seconds / images if calls and images else None
