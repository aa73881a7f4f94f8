"""The reader of ``plan_hit_share.resident``: the program's plan counters
(``codec.plan_hit``, ``codec.plan_miss`` in ``wicca_tpu_torch.utils.timing``)
as a share, None where the program counted neither."""

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
    assert metric_reader("plan_hit_share.resident")(None) is None
    registry.count("codec.plan_hit", 5)  # no session records: nothing is counted
    assert metric_reader("plan_hit_share.resident")(None) is None


@pytest.mark.parametrize("hits,misses,share", [(3, 1, 0.75), (4, 0, 1.0), (0, 2, 0.0)])
def test_the_share_is_hits_over_calls(registry, hits, misses, share):
    with profile(activities=[ProfilerActivity.CPU]):
        for name, n in (("codec.plan_hit", hits), ("codec.plan_miss", misses)):
            for _ in range(n):
                registry.count(name, 1)
    assert metric_reader("plan_hit_share.resident")(None) == share
