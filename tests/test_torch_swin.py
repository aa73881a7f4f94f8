"""The port's Swin Transformer (``wicca_tpu_torch.models.nets.SwinTransformer``,
the registry's ``SwinL384``) against the benchmark's plain float32 reference
(``benchmark/reference/swin.py``, written from the paper; the JAX package has
no Swin), on the CPU at small sizes: C=32, window 4, two stages (heads 2, 4)
at 32x32 (a shifted stage, then one whose grid equals the window) and 64x64
(both shifted), and four stages (heads 2, 4, 8, 16) at 64x64 (the last
stage's grid, 2x2, below the window).

Tolerances, relative to the reference's largest |logit| per row, stated
before measuring:
* float32 (``dtype=torch.float32``): 1e-5; the two sum their products in
  other orders, and a bfloat16 rounding anywhere would miss it by far;
* bfloat16 (the zoo's compute type): 2e-2, the zoo's bound (a rounding of
  2**-9 of q, k, v, the attention weights and every linear map's input,
  carried through up to 8 blocks); the seeded weights here read 0.4-1.1%,
  and the float8 control 6-22%.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.reference import swin as ref
from wicca_tpu_torch.config.constants import MODEL, PRE_INP
from wicca_tpu_torch.models import nets, registry
from wicca_tpu_torch.models.registry import TorchClassifier, load_single_model
from wicca_tpu_torch.utils import timing

F32_TOL = 1e-5
BF16_TOL = 2e-2
TWO = dict(embed_dim=32, depths=[2, 2], num_heads=[2, 4], window_size=4)
FOUR = dict(embed_dim=32, depths=[2, 2, 2, 2], num_heads=[2, 4, 8, 16], window_size=4)
CASES = {"two-32": (TWO, (32, 32)), "two-64": (TWO, (64, 64)), "four-64": (FOUR, (64, 64))}
SWIN_L = dict(embed_dim=192, depths=[2, 2, 18, 2], num_heads=[6, 12, 24, 48], window_size=12, input_size=[384, 384])


def config(widths: dict, size) -> dict:
    return {"patch_size": 4, "mlp_ratio": 4, "num_classes": 1000, **widths, "input_size": list(size)}


def port(cfg: dict, dtype=torch.bfloat16) -> nets.SwinTransformer:
    return nets.SwinTransformer(num_classes=cfg["num_classes"], patch=cfg["patch_size"], dim=cfg["embed_dim"],
                                depths=cfg["depths"], heads=cfg["num_heads"], window=cfg["window_size"],
                                mlp_ratio=cfg["mlp_ratio"], dtype=dtype, image_size=cfg["input_size"])


def gap(got: torch.Tensor, want: torch.Tensor) -> float:
    return float(((got - want).abs().amax(dim=1) / want.abs().amax(dim=1)).max())


@pytest.fixture(scope="module")
def two_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def both(case: str, dtype, seed: int = 0):
    widths, size = CASES[case]
    cfg = config(widths, size)
    weights = ref.make_weights(cfg, seed, "cpu")
    x = torch.rand(2, *size, 3, generator=torch.Generator().manual_seed(seed + 100)) * 4 - 2
    model = port(cfg, dtype).eval()
    model.load_state_dict(dict(zip(model.state_dict(), weights)), strict=True)
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


def test_the_bias_table_and_the_shift_mask_change_the_logits(two_threads):
    """The comparison sees both: with either left out the port leaves the
    float32 tolerance by orders of magnitude."""
    widths, size = CASES["two-32"]
    cfg = config(widths, size)
    weights = ref.make_weights(cfg, 1, "cpu")
    x = torch.rand(1, *size, 3, generator=torch.Generator().manual_seed(5))
    want = ref.forward(x, weights, cfg)
    for broken in ("table", "mask"):
        model = port(cfg, torch.float32).eval()
        model.load_state_dict(dict(zip(model.state_dict(), weights)), strict=True)
        for m in model.modules():
            if broken == "table" and isinstance(m, nets.SwinWindowAttention):
                m.relative_position_bias_table.data.zero_()
            if broken == "mask" and isinstance(m, nets.SwinBlock) and m.attn_mask is not None:
                m.attn_mask.zero_()
        with torch.inference_mode():
            assert gap(model(x.permute(0, 3, 1, 2)), want) > 100 * F32_TOL, broken


def brute_mask(h: int, w: int, m: int, s: int) -> torch.Tensor:
    """The shift mask from its definition, token pair by token pair."""

    def region(v, n):
        return 0 if v < n - m else (1 if v < n - s else 2)

    out = torch.zeros((h // m) * (w // m), m * m, m * m)
    for wy in range(h // m):
        for wx in range(w // m):
            labels = [3 * region(wy * m + i, h) + region(wx * m + j, w) for i in range(m) for j in range(m)]
            for a in range(m * m):
                for b in range(m * m):
                    if labels[a] != labels[b]:
                        out[wy * (w // m) + wx, a, b] = -100.0
    return out


@pytest.mark.parametrize("h,w,m,s", [(8, 8, 4, 2), (16, 8, 4, 2), (24, 24, 12, 6)])
def test_shift_mask_equals_the_brute_force(h, w, m, s):
    want = brute_mask(h, w, m, s)
    assert torch.equal(nets.swin_shift_mask((h, w), m, s), want)
    assert torch.equal(ref.window_tokens(h, w, m, s)[1], want)


@pytest.mark.parametrize("m", [2, 4, 7, 12])
def test_relative_index_equals_the_brute_force(m):
    want = torch.empty(m * m, m * m, dtype=torch.long)
    for a in range(m * m):
        for b in range(m * m):
            dy, dx = a // m - b // m, a % m - b % m
            want[a, b] = (dy + m - 1) * (2 * m - 1) + (dx + m - 1)
    assert torch.equal(nets.swin_relative_index(m), want) and torch.equal(ref.relative_index(m), want)
    assert int(want.min()) == 0 and int(want.max()) == (2 * m - 1) ** 2 - 1


def test_the_stages_windows_and_shifts():
    assert nets.swin_stages((384, 384), 4, 4, 12) == [((96, 96), 12, 6), ((48, 48), 12, 6), ((24, 24), 12, 6),
                                                       ((12, 12), 12, 0)]
    assert nets.swin_stages((64, 64), 4, 4, 4) == [((16, 16), 4, 2), ((8, 8), 4, 2), ((4, 4), 4, 0), ((2, 2), 2, 0)]
    model = port(config(TWO, (32, 32)))
    shifts = [(b.window, b.shift, b.windows) for stage in model.layers for b in stage.blocks]
    assert shifts == [(4, 0, 4), (4, 2, 4), (4, 0, 1), (4, 0, 1)]


def test_init_fills_every_parameter_and_the_bias_tables():
    model = nets.init_weights(port(config(FOUR, (64, 64))), torch.Generator().manual_seed(4))
    for name, p in model.named_parameters():
        assert torch.isfinite(p).all(), name
    tables = [m.relative_position_bias_table for m in model.modules() if isinstance(m, nets.SwinWindowAttention)]
    assert len(tables) == 8
    for t in tables:
        t = t.detach()
        assert t.abs().min() > 0 and 0.01 < float(t.std()) < 0.03


@pytest.mark.parametrize("size", [(224, 224), (384, 380), (36, 36)])
def test_a_size_the_windows_do_not_tile_is_refused(size):
    with pytest.raises(ValueError, match=r"square sizes that work .*384"):
        nets.SwinL384(image_size=size)


def test_a_forward_at_another_size_raises():
    model = port(config(TWO, (32, 32)))
    with pytest.raises(ValueError, match="built for"):
        model(torch.zeros(1, 3, 64, 64))


def test_swin_l384_has_the_published_parameters_and_learned_tensors_only():
    with torch.device("meta"):
        model = registry.build("SwinL384", (384, 384))
    state = model.state_dict()
    assert sum(v.numel() for v in state.values()) == 196_735_516  # Table 1: 197M
    assert list(state) == [n for n, _ in model.named_parameters()]  # no buffer in the state dict
    assert [tuple(v.shape) for v in state.values()] == ref.weight_shapes(config(SWIN_L, (384, 384)))
    assert ref.flops(config(SWIN_L, (384, 384)), 384, 384) == 2 * 103_919_087_616  # Table 1: 103.9G


@pytest.fixture(scope="module")
def swin_l():
    """The registry's SwinL384 at the smallest size its windows tile (the
    same 197M parameters; built and initialized on the CPU once)."""
    clf = load_single_model("SwinL384", (32, 32), device="cpu")
    assert clf is not None
    return clf


def test_load_single_model_gives_a_classifier(swin_l, two_threads):
    assert isinstance(swin_l[MODEL], TorchClassifier) and swin_l[PRE_INP] is registry.preprocess_torch
    pixels = np.random.default_rng(0).integers(0, 256, (2, 32, 32, 3)).astype(np.float32)
    logits = swin_l[MODEL](swin_l[PRE_INP](pixels))
    assert logits.shape == (2, 1000) and logits.dtype == np.float32 and np.isfinite(logits).all()


def test_the_processor_runs_swin_unchanged(swin_l, tmp_path, two_threads):
    import cv2

    from wicca_tpu_torch.harness.processor import ClassifierProcessor

    folder = tmp_path / "images"
    folder.mkdir()
    rng = np.random.default_rng(1)
    for i in range(3):
        cv2.imwrite(str(folder / f"img_{i}.png"), rng.integers(0, 256, (96, 128, 3), dtype=np.uint8))
    out = ClassifierProcessor(folder, transform_depth=2, top_classes=5, results_folder=tmp_path / "results",
                              log_info=False, batch_size=2, device="cpu").process_classifiers({"swin": swin_l})
    assert set(out) == {"swin"}
    assert (tmp_path / "results" / "depth-2" / "swin-depth-2.csv").is_file()


def test_spans_and_the_window_counter_record_under_a_profiler_only(two_threads):
    model = port(config(TWO, (32, 32))).eval()
    nets.init_weights(model, torch.Generator().manual_seed(0))
    x = torch.zeros(3, 3, 32, 32)
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
    assert snap["spans"]["model.swin.attention"][1] == 4 and snap["spans"]["model.swin.merge"][1] == 1
    assert snap["counters"]["model.swin.windows"] == 3 * (4 + 4 + 1 + 1)


def test_swin_l384_queues_234_windows_an_image():
    with torch.device("meta"):
        model = registry.build("SwinL384", (384, 384))
    assert sum(b.windows for stage in model.layers for b in stage.blocks) == 234
