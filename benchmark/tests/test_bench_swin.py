"""The ``classify`` runner and ``swin-l384``'s plain reference on the CPU: the
cell ``swin-l384.2k-depth5`` cut to a tiny Swin (C=32, window 4, two
stages, 32x32 inputs; registered under a test name) and a tiny folder,
correct on a sound program and not correct with the timed path broken
underneath it or with the float8 control in its place; the reference's
operations and parameters against the published Swin-L/384; and the
readers of the cell's new metrics on a planted trace."""

import functools
import json

import pytest
import torch

from benchmark.lib import cell as cells
from benchmark.lib.trace import Trace
from benchmark.reference import swin as ref
from benchmark.tests._cells import run_cell
from benchmark.tests.test_bench_runs import _alter_icon, _alter_logit, _half_batch

CELL = "swin-l384.2k-depth5"
TINY_ARCH = "SwinTest"
TINY = dict(architecture=TINY_ARCH, input_size=[32, 32], embed_dim=32, depths=[2, 2], num_heads=[2, 4],
            window_size=4, batch_size=2)
CONFIG = json.loads((cells.ROOT / "benchmark" / "configs" / "swin-l384.json").read_text())
FAULTS = {"logit": _alter_logit, "icon": _alter_icon, "half": _half_batch}


@pytest.fixture
def tiny_arch():
    from wicca_tpu_torch.models import nets, registry

    registry.register_architecture(TINY_ARCH, functools.partial(nets.SwinTransformer, dim=32, depths=(2, 2),
                                                                heads=(2, 4), window=4), registry.preprocess_torch)
    yield
    del registry._ARCHITECTURES[TINY_ARCH]


def tiny_cell(tmp_path, trace=False, seed=2**31 + 11):
    cell = cells.load(CELL)
    cell.traffic = {**cell.traffic, "frames": [{"shape": [3, 96, 128], "count": 3}]}
    cell.config = {**cell.config, **TINY}
    cell.seed, cell.seconds, cell.trace, cell.device = seed, 0.2, trace, "cpu"
    cell.workdir = tmp_path
    return cell


@pytest.mark.parametrize("trace", [False, True])
def test_sound_run_is_correct(trace, tiny_arch, tmp_path):
    rc, res, err = run_cell(tiny_cell(tmp_path, trace))
    assert rc == 0 and res["correct"] and res["failed"] == 0 and res["attempted"] >= 1, err
    assert set(res["checks"]) == {"input_mismatch", "logit_gap", "csv_mismatch"}
    assert res["checks"]["input_mismatch"]["value"] == 0 and res["checks"]["csv_mismatch"]["value"] == 0
    assert {"model", "inputs", "weights", "png_writes", "warm_call"} <= set(res["setup_parts"])
    if trace:  # the program's spans of the Swin blocks reach the reader (the CPU's trace has no device time)
        assert res["metrics"]["swin_attention_host_ms_per_image"]["value"] > 0, res
    else:
        assert set(res["metrics"]) == {"analysis_mps", "setup_s"}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_broken_program_is_not_correct(fault, tiny_arch, tmp_path, monkeypatch):
    FAULTS[fault](monkeypatch)
    rc, res, err = run_cell(tiny_cell(tmp_path))
    assert rc == 0 and res["correct"] is False and res["failed"] >= 1, (res, err)


def test_control_is_not_correct(tiny_arch, tmp_path):
    from benchmark.control import read

    torch.set_num_threads(2)
    got = read(tiny_cell(tmp_path))
    assert got["correct"] is False and got["checks"]["logit_gap"]["value"] > CONFIG["limits"]["logit_gap"], got


def test_a_program_without_the_architecture_fails_before_the_folder(tmp_path):
    cell = tiny_cell(tmp_path)
    cell.config = {**cell.config, "architecture": "NoSuchModel"}
    with pytest.raises(RuntimeError, match="could not load NoSuchModel"):
        run_cell(cell)
    assert not (tmp_path / "src").exists()


def test_flops_and_parameters_are_the_published_swin_l384():
    cfg = CONFIG
    # Table 1: 103.9G multiply-adds and 197M parameters
    assert ref.flops(cfg, 384, 384) == 2 * 103_919_087_616 == cfg["flops_per_image"]
    assert sum(torch.Size(s).numel() for s in ref.weight_shapes(cfg)) == 196_735_516 == cfg["parameters"]
    assert [s.window for s in ref.stages(cfg, 384, 384)] == [12] * 4
    assert [s.shift for s in ref.stages(cfg, 384, 384)] == [6, 6, 6, 0]


def test_the_reference_refuses_a_size_its_windows_do_not_tile():
    cfg = CONFIG
    with pytest.raises(ValueError, match="not tiled"):
        ref.stages(cfg, 224, 224)


def _run(trace, counters, steps=2):
    return cells.Run(cell=None, setup_s=1.0, steps=[(0.0, 1.0, 1.0)] * steps, spans={}, counters=counters,
                     samples={}, device_name="NVIDIA H100 80GB HBM3", trace=trace)


def test_forward_device_mfu_reads_the_forwards_alone():
    read = cells.metric_reader("forward_device_mfu.swin")
    kernels = [("Memcpy HtoD (Pageable -> Device)", 0, 10**9), ("Memset (Device)", 0, 10**9),
               ("void wicca::icon_u8_kernel<5>", 0, 10**9), ("sm90_xmma_gemm_bf16", 0, 10**9)]
    trace = Trace(window_s=10.0, busy_s=4.0, kernels=kernels, device_ops=[], idle_gaps=[], kinds={}, steps=[0, 0])
    # two traced calls of 98.9 TFLOP each in 1 s of forward time: 2 x 10% of 989 TFLOP/s
    got = read(_run(trace, {"calls": 3, "forward_flops": 3 * 98.9e12}))
    assert got == pytest.approx(20.0)
    trace.unsound = "planted"
    assert read(_run(trace, {"calls": 3, "forward_flops": 3 * 98.9e12})) is None
    assert read(_run(None, {"calls": 3, "forward_flops": 1.0})) is None


def test_attention_host_ms_reads_the_program_s_span():
    from torch.profiler import ProfilerActivity, profile

    from wicca_tpu_torch.utils import timing

    read = cells.metric_reader("swin_attention_host_ms_per_image")
    timing.reset()
    try:
        assert read(_run(None, {})) is None
        with profile(activities=[ProfilerActivity.CPU]):
            with timing.span("model.swin.attention"):
                pass
            timing.count("model.images", 4)
        seconds = timing.snapshot()["spans"]["model.swin.attention"][0]
        assert read(_run(None, {})) == pytest.approx(1e3 * seconds / 4)
    finally:
        timing.reset()
