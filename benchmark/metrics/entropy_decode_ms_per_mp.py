"""Host milliseconds of ``deserialize``'s entropy decoding (the span
``container.entropy_decode``: the decoder threads' pool, waited on) per
frame megapixel deserialized (``container.deserialized_mp``), both kept by
the program (``wicca_tpu_torch.utils.timing``) over the traced window;
None where it keeps neither."""


def read(run):
    from wicca_tpu_torch.utils import timing

    snapshot = getattr(timing, "snapshot", None)
    if snapshot is None:
        return None
    snap = snapshot()
    seconds, calls = snap["spans"].get("container.entropy_decode", (0.0, 0))
    mp = snap["counters"].get("container.deserialized_mp", 0.0)
    return 1e3 * seconds / mp if calls and mp else None
