"""The share of the harness's batches whose classification ran entirely
under the next batch's decode and icons, from the program's counters
``harness.classify_hidden`` and ``harness.batches``
(``wicca_tpu_torch.utils.timing``) over the traced window: hidden / batches;
None where the program counted neither."""


def read(run):
    from wicca_tpu_torch.utils import timing

    snapshot = getattr(timing, "snapshot", None)
    counters = snapshot()["counters"] if snapshot else {}
    hidden, batches = counters.get("harness.classify_hidden", 0), counters.get("harness.batches", 0)
    return hidden / batches if batches else None
