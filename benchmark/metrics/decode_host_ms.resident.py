"""Host milliseconds of ``decode`` per call, from the program's own span
``codec.decode`` (``wicca_tpu_torch.utils.timing``), over the traced
intervals; None where the program keeps no such span."""


def read(run):
    from wicca_tpu_torch.utils import timing

    snapshot = getattr(timing, "snapshot", None)
    seconds, calls = snapshot()["spans"].get("codec.decode", (0.0, 0)) if snapshot else (0.0, 0)
    return 1e3 * seconds / calls if calls else None
