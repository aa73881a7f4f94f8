"""The ``classify`` runner and ``maxvit-xl512``'s plain reference on the CPU:
the cell ``maxvit-xl512.2k-depth5`` cut to a tiny MaxViT (widths 16-32-64-128,
depths 1-1-2-1, heads of width 8, windows of 4, 64x64 inputs; registered
under a test name) and a tiny folder, correct on a sound program and not
correct with the timed path broken underneath it or with the float8
control in its place; the reference's weight list against the program's
state dict; the reference's operations and parameters against the
published MaxViT-XL/512; and the readers of the cell's new metrics on a
planted trace and on the program's spans."""

import functools
import json

import numpy as np
import pytest
import torch

from benchmark.lib import cell as cells
from benchmark.lib.trace import Trace
from benchmark.reference import maxvit as ref
from benchmark.tests._cells import run_cell
from benchmark.tests.test_bench_runs import _alter_icon, _alter_logit, _half_batch

CELL = "maxvit-xl512.2k-depth5"
TINY_ARCH = "MaxViTTest"
TINY = dict(architecture=TINY_ARCH, input_size=[64, 64], stem_width=16, widths=[16, 32, 64, 128], depths=[1, 1, 2, 1],
            head_dim=8, window_size=4, batch_size=2)
CONFIG = json.loads((cells.ROOT / "benchmark" / "configs" / "maxvit-xl512.json").read_text())


def _roll_rows(monkeypatch):
    """Each batch's logits one row down: every row of a batch of two or
    more gets another image's logits."""
    from wicca_tpu_torch.models import registry

    real = registry.TorchClassifier._forward
    monkeypatch.setattr(registry.TorchClassifier, "_forward", lambda self, batch: np.roll(real(self, batch), 1, axis=0))


def _stale_batch(monkeypatch):
    """The logits of the last batch of as many rows in the place of each
    batch's (a stale output buffer): an icon batch gets its sources'."""
    from wicca_tpu_torch.models import registry

    real, last = registry.TorchClassifier._forward, {}

    def forward(self, batch):
        out = real(self, batch)
        stale = last.get(len(batch), out)
        last[len(batch)] = out
        return stale

    monkeypatch.setattr(registry.TorchClassifier, "_forward", forward)


FAULTS = {"logit": _alter_logit, "icon": _alter_icon, "half": _half_batch, "rolled_rows": _roll_rows,
          "stale_batch": _stale_batch}


def tiny_factory():
    from wicca_tpu_torch.models import nets

    return functools.partial(nets.MaxViT, stem=16, dims=(16, 32, 64, 128), depths=(1, 1, 2, 1), head_dim=8, window=4)


@pytest.fixture
def tiny_arch():
    from wicca_tpu_torch.models import registry

    registry.register_architecture(TINY_ARCH, tiny_factory(), registry.preprocess_minus1_1)
    yield
    del registry._ARCHITECTURES[TINY_ARCH]


def tiny_cell(tmp_path, trace=False, seed=2**31 + 11):
    cell = cells.load(CELL)
    cell.traffic = {**cell.traffic, "frames": [{"shape": [3, 96, 128], "count": 3}]}
    cell.config = {**cell.config, **TINY}
    cell.seed, cell.seconds, cell.trace, cell.device = seed, 0.2, trace, "cpu"
    cell.workdir = tmp_path
    return cell


def test_the_weight_list_follows_the_program_s_state_dict():
    """Shapes in the state dict's order, at the tiny size and (on the meta
    device) at XL/512: the runner hands the weights over by position."""
    cfg = {**CONFIG, **TINY}
    state = tiny_factory()(image_size=(64, 64)).state_dict()
    assert [tuple(v.shape) for v in state.values()] == ref.weight_shapes(cfg)
    from wicca_tpu_torch.models import registry

    with torch.device("meta"):
        big = registry.build("MaxViTXL512", (512, 512)).state_dict()
    assert [tuple(v.shape) for v in big.values()] == ref.weight_shapes(CONFIG)


@pytest.mark.parametrize("trace", [False, True])
def test_sound_run_is_correct(trace, tiny_arch, tmp_path):
    rc, res, err = run_cell(tiny_cell(tmp_path, trace))
    assert rc == 0 and res["correct"] and res["failed"] == 0 and res["attempted"] >= 1, err
    assert set(res["checks"]) == {"input_mismatch", "logit_gap", "csv_mismatch"}
    assert res["checks"]["input_mismatch"]["value"] == 0 and res["checks"]["csv_mismatch"]["value"] == 0
    assert {"model", "inputs", "weights", "png_writes", "warm_call"} <= set(res["setup_parts"])
    if trace:  # the program's MaxViT spans reach the readers (the CPU's trace has no device time)
        assert res["metrics"]["maxvit_grid_attention_host_ms_per_image"]["value"] > 0, res
        assert res["metrics"]["maxvit_mbconv_host_ms_per_image"]["value"] > 0, res
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


def _folder_logits(tmp_path, count=8):
    from benchmark.lib.cell import runner_class

    torch.set_num_threads(2)
    cell = tiny_cell(tmp_path)
    cell.traffic = {**cell.traffic, "frames": [{"shape": [3, 96, 128], "count": count}]}
    runner = runner_class(cell)(cell)
    runner.device = torch.device("cpu")
    runner.make_inputs()
    return runner._reference_logits(runner._reference_inputs())


def test_the_seeded_logits_top_1_takes_more_than_one_class(tmp_path):
    """Over the folder's rows (each source and its icon), so that
    ``csv_mismatch`` compares classes that differ from row to row."""
    logits = _folder_logits(tmp_path)
    assert len(logits) == 16
    assert len({int(np.argmax(v)) for v in logits.values()}) > 1


def test_the_logits_of_two_inputs_differ_by_thrice_the_limit(tmp_path):
    """The least ``logit_gap`` between the reference logits of two
    different rows (two images, or an image and its icon): a program that
    hands a row another row's logits leaves the limit."""
    logits = _folder_logits(tmp_path)
    rows = np.stack(list(logits.values())).astype(np.float64)
    gaps = np.abs(rows[:, None] - rows[None]).max(axis=2) / np.abs(rows).max(axis=1)[None]
    least = gaps[~np.eye(len(rows), dtype=bool)].min()
    assert least > 3 * CONFIG["limits"]["logit_gap"], least


def test_a_program_without_the_architecture_fails_before_the_folder(tmp_path):
    cell = tiny_cell(tmp_path)
    cell.config = {**cell.config, "architecture": "NoSuchModel"}
    with pytest.raises(RuntimeError, match="could not load NoSuchModel"):
        run_cell(cell)
    assert not (tmp_path / "src").exists()


def test_flops_and_parameters_are_the_published_maxvit_xl512():
    cfg = CONFIG
    # Table 2: 535.2G multiply-adds (this count: 531.15G, 0.76% under) and 475M parameters
    assert ref.flops(cfg, 512, 512) == 2 * 531_153_334_272 == cfg["flops_per_image"]
    assert abs(ref.flops(cfg, 512, 512) / 2 / 535.2e9 - 1) < 0.01
    assert [(s.h, s.dim, s.heads, s.window, s.depth) for s in ref.stages(cfg, 512, 512)] == [
        (128, 192, 6, 16, 2), (64, 384, 12, 16, 6), (32, 768, 24, 16, 14), (16, 1536, 48, 16, 2)]
    assert sum(torch.Size(s).numel() for s in ref.weight_shapes(cfg)) == 476_101_264  # with the BatchNorm statistics
    with torch.device("meta"):
        from wicca_tpu_torch.models import registry

        model = registry.build("MaxViTXL512", (512, 512))
    assert sum(p.numel() for p in model.parameters()) == 475_806_352 == cfg["parameters"]


def test_the_reference_refuses_a_size_its_partitions_do_not_tile():
    with pytest.raises(ValueError, match="not tiled"):
        ref.stages(CONFIG, 384, 384)


def _run(trace, counters, steps=2):
    return cells.Run(cell=None, setup_s=1.0, steps=[(0.0, 1.0, 1.0)] * steps, spans={}, counters=counters,
                     samples={}, device_name="NVIDIA H100 80GB HBM3", trace=trace)


def test_forward_device_mfu_reads_the_forwards_alone():
    read = cells.metric_reader("forward_device_mfu.maxvit")
    kernels = [("Memcpy HtoD (Pageable -> Device)", 0, 10**9), ("Memset (Device)", 0, 10**9),
               ("void wicca::icon_u8_kernel<5>", 0, 10**9), ("sm90_xmma_gemm_bf16", 0, 10**9)]
    trace = Trace(window_s=10.0, busy_s=4.0, kernels=kernels, device_ops=[], idle_gaps=[], kinds={}, steps=[0, 0])
    # two traced calls of 98.9 TFLOP each in 1 s of forward time: 2 x 10% of 989 TFLOP/s
    got = read(_run(trace, {"calls": 3, "forward_flops": 3 * 98.9e12}))
    assert got == pytest.approx(20.0)
    trace.unsound = "planted"
    assert read(_run(trace, {"calls": 3, "forward_flops": 3 * 98.9e12})) is None
    assert read(_run(None, {"calls": 3, "forward_flops": 1.0})) is None


@pytest.mark.parametrize("metric,span", [("maxvit_grid_attention_host_ms_per_image", "model.maxvit.grid_attention"),
                                         ("maxvit_mbconv_host_ms_per_image", "model.maxvit.mbconv")])
def test_host_ms_reads_the_program_s_span(metric, span):
    from torch.profiler import ProfilerActivity, profile

    from wicca_tpu_torch.utils import timing

    read = cells.metric_reader(metric)
    timing.reset()
    try:
        assert read(_run(None, {})) is None
        with profile(activities=[ProfilerActivity.CPU]):
            with timing.span(span):
                pass
            timing.count("model.images", 4)
        seconds = timing.snapshot()["spans"][span][0]
        assert read(_run(None, {})) == pytest.approx(1e3 * seconds / 4)
    finally:
        timing.reset()
