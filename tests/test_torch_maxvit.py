"""The port's MaxViT (``wicca_tpu_torch.models.nets.MaxViT``, the registry's
``MaxViTXL512``) against the benchmark's plain float32 reference
(``benchmark/reference/maxvit.py``, written from the paper; the JAX package
has no MaxViT), on the CPU at small sizes: widths 16-32-64-128, heads of
width 8, windows of 4, depths 1-1-2-1 at 128x128 (every stage's grid tiled
by 4 x 4 windows, the last stage's 4 x 4 grid one window in both
partitions) and all 24 blocks (2-6-14-2) at 64x64 (the last two stages'
grids smaller than the window). XL/512 itself is built on the ``meta``
device only.

Tolerances, relative to the reference's largest |logit| per row, stated
before measuring:
* float32 (``dtype=torch.float32``): 1e-5; the two sum their products in
  other orders, and a bfloat16 rounding anywhere would miss it by far;
* bfloat16 (the zoo's compute type): 2e-2, the zoo's bound (a rounding of
  2**-9 of every convolution's and linear map's input, q, k, v and the
  attention weights, carried through up to 24 blocks).
"""

import functools
import re

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.reference import maxvit as ref
from benchmark.reference import swin as ref_swin
from wicca_tpu_torch.config.constants import MODEL, PRE_INP
from wicca_tpu_torch.models import nets, registry
from wicca_tpu_torch.models.registry import TorchClassifier, load_single_model
from wicca_tpu_torch.utils import timing

F32_TOL = 1e-5
BF16_TOL = 2e-2
SMALL = dict(stem_width=16, widths=[16, 32, 64, 128], head_dim=8, window_size=4)
CASES = {"small-128": ([1, 1, 2, 1], (128, 128)), "deep-64": ([2, 6, 14, 2], (64, 64))}
XL = dict(stem_width=192, widths=[192, 384, 768, 1536], depths=[2, 6, 14, 2], head_dim=32, window_size=16)
TINY_ARCH = "MaxViTTiny"


def config(depths, size, **widths) -> dict:
    return {**SMALL, **widths, "depths": list(depths), "expand_ratio": 4, "se_ratio": 0.25, "mlp_ratio": 4,
            "bn_eps": 1e-3, "layer_norm_eps": 1e-5, "num_classes": 1000, "input_size": list(size)}


def port(cfg: dict, dtype=torch.bfloat16) -> nets.MaxViT:
    return nets.MaxViT(num_classes=cfg["num_classes"], stem=cfg["stem_width"], dims=tuple(cfg["widths"]),
                       depths=tuple(cfg["depths"]), head_dim=cfg["head_dim"], window=cfg["window_size"],
                       expand=cfg["expand_ratio"], mlp_ratio=cfg["mlp_ratio"], dtype=dtype,
                       image_size=cfg["input_size"])


def gap(got: torch.Tensor, want: torch.Tensor) -> float:
    return float(((got - want).abs().amax(dim=1) / want.abs().amax(dim=1)).max())


@pytest.fixture(scope="module")
def two_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def loaded(cfg: dict, dtype, seed: int) -> tuple[nets.MaxViT, list]:
    weights = ref.make_weights(cfg, seed, "cpu")
    model = port(cfg, dtype).eval()
    model.load_state_dict(dict(zip(model.state_dict(), weights)), strict=True)
    return model, weights


def inputs(size, seed: int, n: int = 2) -> torch.Tensor:
    return torch.rand(n, *size, 3, generator=torch.Generator().manual_seed(seed + 100)) * 2 - 1


def both(case: str, dtype, seed: int = 0):
    depths, size = CASES[case]
    cfg = config(depths, size)
    model, weights = loaded(cfg, dtype, seed)
    x = inputs(size, seed)
    with torch.inference_mode():
        got = model(x.permute(0, 3, 1, 2))
    return got, ref.forward(x, weights, cfg)


@pytest.mark.parametrize("case", list(CASES))
def test_float32_equals_the_reference(case, two_threads):
    got, want = both(case, torch.float32)
    assert got.dtype == torch.float32 and got.shape == want.shape == (2, 1000)
    assert gap(got, want) <= F32_TOL


@pytest.mark.parametrize("case", list(CASES))
def test_bfloat16_within_its_tolerance(case, two_threads):
    got, want = both(case, torch.bfloat16, seed=3)
    assert gap(got, want) <= BF16_TOL


def _no_se(m):
    m.se.forward = lambda y: y


def _zero_tables(m):
    m.relative_position_bias_table.data.zero_()


def _plain_statistics(m):
    m.running_mean.zero_()
    m.running_var.fill_(1.0)


BREAKS = {"bias tables": (nets.WindowAttention, _zero_tables), "squeeze-excite": (nets.MaxViTMBConv, _no_se),
          "BatchNorm statistics": (nets.BatchNorm, _plain_statistics)}


@pytest.mark.parametrize("broken", list(BREAKS))
def test_each_path_changes_the_logits(broken, two_threads):
    """The comparison sees the bias tables, the squeeze-excite and the
    BatchNorm statistics: with any left out the port leaves the float32
    tolerance by orders of magnitude."""
    depths, size = CASES["small-128"]
    cfg = config(depths, size)
    model, weights = loaded(cfg, torch.float32, 1)
    x = inputs(size, 5, 1)
    want = ref.forward(x, weights, cfg)
    kind, brk = BREAKS[broken]
    for m in model.modules():
        if isinstance(m, kind):
            brk(m)
    with torch.inference_mode():
        assert gap(model(x.permute(0, 3, 1, 2)), want) > 100 * F32_TOL


def brute_tokens(h: int, w: int, p: int, partition: str) -> torch.Tensor:
    """Each window's flat grid indices from the definition, loop by loop."""
    out = []
    for a in range(h // p):
        for b in range(w // p):
            if partition == "block":
                out.append([(a * p + i) * w + b * p + j for i in range(p) for j in range(p)])
            else:
                out.append([(i * (h // p) + a) * w + j * (w // p) + b for i in range(p) for j in range(p)])
    return torch.tensor(out)


@pytest.mark.parametrize("h,w,p", [(8, 8, 4), (16, 8, 4), (12, 24, 6), (4, 4, 4)])
@pytest.mark.parametrize("partition", ["block", "grid"])
def test_partitions_and_their_inverses_equal_the_brute_force(h, w, p, partition):
    want = brute_tokens(h, w, p, partition)
    assert torch.equal(ref.window_tokens(h, w, p, partition), want)
    part, unpart = {"block": (nets._windows, nets._unwindows), "grid": (nets._grid_windows, nets._ungrid_windows)}[
        partition]
    grid = torch.arange(2 * h * w * 3).view(2, h, w, 3)  # two images, three channels
    windows = part(grid, p)
    assert windows.shape == (2 * want.shape[0], p * p, 3)
    flat = grid.view(2, h * w, 3)
    assert torch.equal(windows.view(2, -1, p * p, 3), flat[:, want])
    assert torch.equal(unpart(windows, p, h, w), grid)


def test_the_partition_attention_uses_swin_s_relative_index():
    model = port(config([1, 1, 2, 1], (128, 128)))
    attns = [m for m in model.modules() if isinstance(m, nets.WindowAttention)]
    assert len(attns) == 10 and nets.SwinWindowAttention is nets.WindowAttention
    for a in attns:
        assert torch.equal(a.relative_position_index, nets.swin_relative_index(4))
    for m in (2, 4, 16):
        assert torch.equal(ref.relative_index(m), ref_swin.relative_index(m))
        assert torch.equal(ref.relative_index(m), nets.swin_relative_index(m))


def test_the_stages_grids_and_windows():
    assert nets.maxvit_stages((512, 512), 4, 16) == [((128, 128), 16), ((64, 64), 16), ((32, 32), 16),
                                                      ((16, 16), 16)]
    assert nets.maxvit_stages((64, 64), 4, 4) == [((16, 16), 4), ((8, 8), 4), ((4, 4), 4), ((2, 2), 2)]
    cfg = config([2, 6, 14, 2], (64, 64))
    assert [(s.h, s.w, s.window) for s in ref.stages(cfg, 64, 64)] == [(16, 16, 4), (8, 8, 4), (4, 4, 4), (2, 2, 2)]


@pytest.mark.parametrize("size,fault", [((384, 384), "stage 2's 24x24 tokens are not tiled by 16x16"),
                                        ((224, 224), "stage 0's 56x56 tokens are not tiled by 16x16"),
                                        ((512, 520), "stage 0's 128x130 tokens are not tiled by 16x16"),
                                        ((48, 48), "the 3x3 grid before stage 3 does not halve")])
def test_a_size_the_partitions_do_not_tile_is_refused(size, fault):
    with pytest.raises(ValueError, match=f"cannot tile {re.escape(str(size))}: {fault}"):
        nets.MaxViTXL512(image_size=size)


def test_a_forward_at_another_size_raises():
    model = port(config([1, 1, 2, 1], (128, 128)))
    with pytest.raises(ValueError, match="built for"):
        model(torch.zeros(1, 3, 64, 64))


def test_init_fills_every_parameter_and_the_bias_tables():
    model = nets.init_weights(port(config([1, 1, 2, 1], (128, 128))), torch.Generator().manual_seed(4))
    for name, t in model.state_dict().items():
        assert torch.isfinite(t).all(), name
    tables = [m.relative_position_bias_table.detach() for m in model.modules() if isinstance(m, nets.WindowAttention)]
    assert len(tables) == 10
    for t in tables:
        assert t.abs().min() > 0 and 0.01 < float(t.std()) < 0.03


def test_maxvit_xl512_has_the_published_parameters_and_no_derived_buffer():
    with torch.device("meta"):
        model = registry.build("MaxViTXL512", (512, 512))
    assert sum(p.numel() for p in model.parameters()) == 475_806_352  # Table 2: 475M
    state = model.state_dict()
    statistics = {n for n, _ in model.named_buffers() if n.endswith(("running_mean", "running_var"))}
    assert set(state) == {n for n, _ in model.named_parameters()} | statistics  # no index buffer
    cfg = {**config(XL["depths"], (512, 512)), **XL}
    assert [tuple(v.shape) for v in state.values()] == ref.weight_shapes(cfg)
    assert ref.flops(cfg, 512, 512) == 1_062_306_668_544  # 531.15G multiply-adds; Table 2: 535.2G


def test_maxvit_xl512_queues_564_windows_an_image():
    with torch.device("meta"):
        model = registry.build("MaxViTXL512", (512, 512))
    blocks = [b for stage in model.stages for b in stage]
    assert len(blocks) == 24
    assert sum(b.attn_block.windows + b.attn_grid.windows for b in blocks) == 564


def test_spans_and_the_window_counter_record_under_a_profiler_only(two_threads):
    model = nets.init_weights(port(config([1, 1, 2, 1], (128, 128))).eval(), torch.Generator().manual_seed(0))
    x = torch.zeros(3, 3, 128, 128)
    timing.reset()
    try:
        with torch.inference_mode():
            model(x)
            assert timing.snapshot() == {"spans": {}, "counters": {}}
            with profile(activities=[ProfilerActivity.CPU]):
                model(x)
        snap = timing.snapshot()
    finally:
        timing.reset()
    spans = snap["spans"]
    assert spans["model.maxvit.mbconv"][1] == spans["model.maxvit.block_attention"][1] == 5
    assert spans["model.maxvit.grid_attention"][1] == 5
    assert snap["counters"]["model.maxvit.windows"] == 3 * 2 * (64 + 16 + 4 + 4 + 1)


@pytest.fixture
def tiny_maxvit():
    """A MaxViT registered under a test name: the registry's loader and the
    harness take it as they take ``MaxViTXL512``, which is not built whole
    on the CPU."""
    registry.register_architecture(TINY_ARCH, functools.partial(nets.MaxViT, stem=16, dims=(16, 32, 64, 128),
                                                                depths=(1, 1, 2, 1), head_dim=8, window=4),
                                   registry.preprocess_minus1_1)
    clf = load_single_model(TINY_ARCH, (64, 64), device="cpu")
    yield clf
    del registry._ARCHITECTURES[TINY_ARCH]


def test_maxvit_xl512_is_registered_with_the_tf_preprocessing():
    factory, pre = registry._ARCHITECTURES["MaxViTXL512"]
    assert factory is nets.MaxViTXL512 and pre is registry.preprocess_minus1_1


def test_load_single_model_gives_a_classifier(tiny_maxvit, two_threads):
    assert isinstance(tiny_maxvit[MODEL], TorchClassifier) and tiny_maxvit[PRE_INP] is registry.preprocess_minus1_1
    pixels = np.random.default_rng(0).integers(0, 256, (2, 64, 64, 3)).astype(np.float32)
    logits = tiny_maxvit[MODEL](tiny_maxvit[PRE_INP](pixels))
    assert logits.shape == (2, 1000) and logits.dtype == np.float32 and np.isfinite(logits).all()


def test_the_processor_runs_maxvit_unchanged(tiny_maxvit, tmp_path, two_threads):
    import cv2

    from wicca_tpu_torch.harness.processor import ClassifierProcessor

    folder = tmp_path / "images"
    folder.mkdir()
    rng = np.random.default_rng(1)
    for i in range(3):
        cv2.imwrite(str(folder / f"img_{i}.png"), rng.integers(0, 256, (96, 128, 3), dtype=np.uint8))
    out = ClassifierProcessor(folder, transform_depth=2, top_classes=5, results_folder=tmp_path / "results",
                              log_info=False, batch_size=2, device="cpu").process_classifiers({"maxvit": tiny_maxvit})
    assert set(out) == {"maxvit"}
    assert (tmp_path / "results" / "depth-2" / "maxvit-depth-2.csv").is_file()
