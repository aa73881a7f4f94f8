"""The trace reduction's interval arithmetic."""

from benchmark.lib import trace


def test_merge_overlapping_intervals_of_several_streams():
    assert trace._merge([(5, 9), (0, 3), (2, 4), (8, 12)]) == [[0, 4], [5, 12]]


def test_gaps_take_the_innermost_host_event():
    cpu = [(0, 100, "bench.host"), (10, 30, "aten::empty"), (60, 70, "cudaLaunchKernel")]
    got = trace._name_gaps([(12, 28), (40, 50), (61, 69), (101, 120)], cpu)
    assert got == {"aten::empty": 16, "bench.host": 10, "cudaLaunchKernel": 8,
                   "host: outside any recorded op": 19}


def test_a_gap_is_split_over_the_host_events_it_spans():
    cpu = [(0, 100, "bench.host"), (10, 30, "aten::empty"), (60, 70, "cudaLaunchKernel")]
    assert trace._name_gaps([(25, 65)], cpu) == {"aten::empty": 5, "bench.host": 30, "cudaLaunchKernel": 5}
