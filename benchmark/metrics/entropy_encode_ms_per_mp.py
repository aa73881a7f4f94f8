"""Host milliseconds of ``serialize``'s entropy coding (the span
``container.entropy_encode``: the coder threads' pool, waited on) per frame
megapixel serialized (``container.serialized_mp``), both kept by the
program (``wicca_tpu_torch.utils.timing``) over the traced window; None
where it keeps neither."""


def read(run):
    from wicca_tpu_torch.utils import timing

    snapshot = getattr(timing, "snapshot", None)
    if snapshot is None:
        return None
    snap = snapshot()
    seconds, calls = snap["spans"].get("container.entropy_encode", (0.0, 0))
    mp = snap["counters"].get("container.serialized_mp", 0.0)
    return 1e3 * seconds / mp if calls and mp else None
