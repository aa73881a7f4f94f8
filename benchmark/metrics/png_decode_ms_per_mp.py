"""Host milliseconds of the decode pool's ``data.load_image`` spans (summed
over its threads) per megapixel decoded (``data.decoded_mp``), both kept by
the program (``wicca_tpu_torch.utils.timing``) over the traced window;
None where it keeps neither."""


def read(run):
    from wicca_tpu_torch.utils import timing

    snapshot = getattr(timing, "snapshot", None)
    if snapshot is None:
        return None
    snap = snapshot()
    seconds, calls = snap["spans"].get("data.load_image", (0.0, 0))
    mp = snap["counters"].get("data.decoded_mp", 0.0)
    return 1e3 * seconds / mp if calls and mp else None
