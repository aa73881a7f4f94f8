"""Host milliseconds of the MaxViT blocks' grid attention (the program's
``model.maxvit.grid_attention`` spans: the dilated partition, the
attention with its relative bias, and the inverse, dispatched on the
classifier threads) per image forwarded (``model.images``), both kept by
the program (``wicca_tpu_torch.utils.timing``) over the traced window;
None where it keeps neither.

Where the launch queue is full, a dispatch waits for the card, and the
span holds that wait: in the MaxViT cell it does (PERF.md, section 3), so
the reading is the host's dispatch plus the device's back-pressure, and a
faster forward on the card lowers it too. A change to the host's dispatch
is judged by it beside ``forward_device_mfu.maxvit``."""


def read(run):
    from wicca_tpu_torch.utils import timing

    snapshot = getattr(timing, "snapshot", None)
    if snapshot is None:
        return None
    snap = snapshot()
    seconds, calls = snap["spans"].get("model.maxvit.grid_attention", (0.0, 0))
    images = snap["counters"].get("model.images", 0)
    return 1e3 * seconds / images if calls and images else None
