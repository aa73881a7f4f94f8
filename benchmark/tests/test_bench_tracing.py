"""The readers of the metrics that the program's own spans and counters
feed (``wicca_tpu_torch.utils.timing``), in runs of their cells at a tiny
size on the CPU: a number in a traced run, None in an untraced one. The
runs share this process, and with it the program's registry, so each
starts with it emptied."""

import pytest

from benchmark.lib import cell as cell_module
from benchmark.lib.cell import metric_reader
from benchmark.tests._cells import run_cell, tiny_cell

READERS = {
    "haar-d5.resident": ["encode_host_ms.resident", "decode_host_ms.resident"],
    "mobilenetv2.2k-depth5": ["png_decode_ms_per_mp", "forward_host_ms_per_image"],
    "haar-d5.wct": ["entropy_encode_ms_per_mp", "entropy_decode_ms_per_mp", "upload_gbps.wct"],
}
ON_THE_CPU = {name for names in READERS.values() for name in names} - {"upload_gbps.wct"}  # no device copies


def _run(workload, tmp_path, monkeypatch, trace):
    """The result line and the record the readers read, with an empty registry first."""
    from wicca_tpu_torch.utils import timing

    timing.reset()
    runs, real = [], cell_module.Run

    def record(**kw):
        runs.append(real(**kw))
        return runs[-1]

    monkeypatch.setattr(cell_module, "Run", record)
    rc, res, err = run_cell(tiny_cell(workload, tmp_path, trace=trace))
    assert rc == 0 and res["correct"], err
    return res, runs[-1]


@pytest.mark.parametrize("workload", sorted(READERS))
def test_a_traced_run_reports_the_program_s_spans(workload, tmp_path, monkeypatch):
    res, run = _run(workload, tmp_path, monkeypatch, trace=True)
    for name in READERS[workload]:
        if name in ON_THE_CPU:
            assert res["metrics"][name]["value"] > 0, (name, res["metrics"])
            assert metric_reader(name)(run) == res["metrics"][name]["value"]
    assert any(n.startswith("wicca.") for n, _ in res["breakdown"]["idle_gaps"]), res["breakdown"]


@pytest.mark.parametrize("workload", sorted(READERS))
def test_an_untraced_run_reads_nothing(workload, tmp_path, monkeypatch):
    _, run = _run(workload, tmp_path, monkeypatch, trace=False)
    for name in READERS[workload]:
        assert metric_reader(name)(run) is None, name


def test_upload_rate_is_the_program_s_bytes_over_the_traced_copies(tmp_path, monkeypatch):
    from wicca_tpu_torch.utils import timing

    res, run = _run("haar-d5.wct", tmp_path, monkeypatch, trace=True)
    read = metric_reader("upload_gbps.wct")
    assert "upload_gbps.wct" not in res["metrics"] and read(run) is None  # the CPU's trace holds no copy
    up = timing.snapshot()["counters"]["link.up_bytes"]
    channels = run.cell.traffic["frames"][0]["shape"][0]
    assert up > channels * run.units * 1e6  # every step's frame, and its stream
    run.trace.kernels.append(("Memcpy HtoD (Pageable -> Device)", 0, 2_000_000))  # a planted 2 ms copy
    assert read(run) == pytest.approx(up / 1e9 / 2e-3)
    run.trace.unsound = "planted disagreement"
    assert read(run) is None
