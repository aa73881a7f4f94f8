"""The reader of ``classify_hidden_share.analysis``: the harness's batch
counters (``harness.classify_hidden``, ``harness.batches`` in
``wicca_tpu_torch.utils.timing``) as a share, None where the program
counted neither."""

import pytest
from torch.profiler import ProfilerActivity, profile

from benchmark.lib.cell import metric_reader


@pytest.fixture
def registry():
    from wicca_tpu_torch.utils import timing

    timing.reset()
    yield timing
    timing.reset()


def test_no_counters_read_nothing(registry):
    assert metric_reader("classify_hidden_share.analysis")(None) is None
    registry.count("harness.batches", 3)  # no session records: nothing is counted
    registry.count("harness.classify_hidden", 2)
    assert metric_reader("classify_hidden_share.analysis")(None) is None


@pytest.mark.parametrize("hidden,batches,share", [(2, 3, 2 / 3), (1, 3, 1 / 3), (0, 3, 0.0), (42, 63, 2 / 3)])
def test_the_share_is_hidden_over_batches(registry, hidden, batches, share):
    with profile(activities=[ProfilerActivity.CPU]):
        for name, n in (("harness.classify_hidden", hidden), ("harness.batches", batches)):
            for _ in range(n):
                registry.count(name, 1)
    assert metric_reader("classify_hidden_share.analysis")(None) == pytest.approx(share)
