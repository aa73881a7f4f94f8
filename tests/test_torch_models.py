"""The port's model zoo (``wicca_tpu_torch.models.nets``, ``registry``,
``interop``) against the JAX package's (``wicca_tpu.models``).

Each case fills the Flax variable tree of a JAX zoo model (its shapes from
``jax.eval_shape(module.init)``) with seeded numpy values (LeCun-scaled
kernels, random biases, BatchNorm statistics and scales, so that every
layout rule and every normalization leaf shows), runs the JAX model
(``jax.jit(module.apply)``) and the port's model holding the same values
(``from_flax_variables``) on the same seeded NHWC batch, both on the CPU.

Tolerances, stated before measuring and relative to the largest |logit| of
the JAX model (s):
* float32 on both sides: |port - jax| <= 1e-5 * s, and the same top-1
  wherever the top-1 margin exceeds twice that bound (every case here).
  The two frameworks sum convolutions in other orders; a bfloat16 compute
  anywhere in the port would miss this by two orders of magnitude.
* bfloat16 (the zoo's compute type) on both sides: |port - jax| <= 2e-2 * s,
  a few bfloat16 roundings (2**-8 each) carried through the depth.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_dwt97 import one_torch_thread  # noqa: F401 (fixture)
from wicca_tpu.models import flax_models as fm
from wicca_tpu.models import registry as jreg
from wicca_tpu_torch.config.constants import MODEL, PRE_INP
from wicca_tpu_torch.models import interop, nets, registry
from wicca_tpu_torch.models.registry import (
    available_architectures,
    load_single_model,
    register_architecture,
)

FLAX = {"SimpleCNN": fm.SimpleCNN, "MobileNetV2": fm.MobileNetV2, "ResNet50": fm.ResNet50,
        "EfficientNetB0": fm.EfficientNetB0, "VGG16": fm.VGG16, "VGG19": fm.VGG19, "DenseNet121": fm.DenseNet121,
        "ViTS16": fm.ViTS16, "ViTTiny16": fm.ViTTiny16}
F32_TOL = 1e-5
BF16_TOL = 2e-2


def flax_module(arch: str, dtype=jnp.float32):
    return dataclasses.replace(FLAX[arch](), dtype=dtype)


def variables(module, shape, seed=0):
    """The module's Flax variable tree, filled with seeded numpy values."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), jnp.zeros((1, *shape, 3), jnp.float32))

    def leaf(path, s):
        col, name = path[0].key, path[-1].key
        if col == "batch_stats":
            v = rng.normal(0, 0.1, s.shape) if name == "mean" else rng.uniform(0.5, 1.5, s.shape)
        elif name == "kernel":
            fan_in = s.shape[0] if len(s.shape) == 3 and path[-2].key != "out" else int(np.prod(s.shape[:-1]))
            v = rng.standard_normal(s.shape) / np.sqrt(fan_in)
        elif name == "scale":
            v = rng.uniform(0.5, 1.5, s.shape)
        else:
            v = rng.normal(0, 0.02 if name == "pos_embed" else 0.1, s.shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def both(arch, shape, dtype="float32", seed=0, tree=None):
    module = flax_module(arch, getattr(jnp, dtype))
    tree = variables(module, shape, seed) if tree is None else tree
    x = np.random.default_rng(seed + 1).uniform(-1, 1, (2, *shape, 3)).astype(np.float32)
    want = np.asarray(jax.jit(module.apply)(tree, jnp.asarray(x)))
    model = registry.build(arch, shape, dtype=getattr(torch, dtype)).eval()
    model.load_state_dict(interop.from_flax_variables(arch, tree, shape), strict=True)
    with torch.inference_mode():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    return got, want


def assert_logits_close(got, want, tol):
    """Within ``tol`` of the largest |logit|, and the same top-1 wherever
    the JAX model's top-1 margin exceeds twice that bound (random weights
    leave near ties, which a bfloat16 rounding may reorder)."""
    assert got.dtype == np.float32 and got.shape == want.shape
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (err, scale)
    top2 = np.sort(want, axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2 * tol * scale
    np.testing.assert_array_equal(got.argmax(-1)[clear], want.argmax(-1)[clear])


@pytest.mark.parametrize("arch,shape", [(a, (32, 32)) for a in FLAX]
                         + [(a, (57, 71)) for a in ("SimpleCNN", "MobileNetV2", "EfficientNetB0")])
def test_logits_equal_the_flax_zoo_at_float32(arch, shape):
    """Odd sizes pad asymmetrically under Flax's SAME rule (and VGG/ViT
    size their first dense layer and token count from the input)."""
    assert_logits_close(*both(arch, shape), F32_TOL)


def test_logits_equal_the_flax_zoo_at_bfloat16():
    assert_logits_close(*both("ResNet50", (32, 32), "bfloat16"), BF16_TOL)


def test_jax_init_carries_across():
    """The JAX package's own init (jax.random), carried as it comes."""
    module = flax_module("SimpleCNN")
    tree = jax.tree.map(np.asarray, module.init(jax.random.PRNGKey(3), jnp.zeros((1, 32, 32, 3))))
    assert_logits_close(*both("SimpleCNN", (32, 32), tree=tree), F32_TOL)


@pytest.mark.parametrize("arch", list(FLAX))
def test_parameter_counts_equal_the_flax_trees(arch):
    shapes = jax.eval_shape(flax_module(arch).init, jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)))
    with torch.device("meta"):
        model = registry.build(arch)
    assert sum(v.numel() for v in model.state_dict().values()) == sum(
        int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))


@pytest.mark.parametrize("arch", ["MobileNetV2", "ViTTiny16", "VGG16"])
def test_to_flax_variables_inverts_the_carry(arch):
    tree = variables(flax_module(arch), (32, 32), seed=4)
    model = registry.build(arch, (32, 32))
    model.load_state_dict(interop.from_flax_variables(arch, tree, (32, 32)), strict=True)
    back = interop.to_flax_variables(model)
    want = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert set(map(jax.tree_util.keystr, got)) == set(map(jax.tree_util.keystr, want))
    by_name = {jax.tree_util.keystr(k): v for k, v in got.items()}
    for k, v in want.items():
        np.testing.assert_array_equal(by_name[jax.tree_util.keystr(k)], v)


def test_carry_refuses_what_does_not_fit():
    tree = variables(flax_module("SimpleCNN"), (32, 32))
    bad = jax.tree.map(np.copy, tree)
    bad["params"]["Conv_0"]["kernel"] = np.zeros((3, 3, 3, 17), np.float32)
    with pytest.raises(ValueError, match="shape mismatch"):
        interop.from_flax_variables("SimpleCNN", bad, (32, 32))
    bad = jax.tree.map(np.copy, tree)
    del bad["params"]["Dense_0"]
    with pytest.raises(ValueError, match="not covered"):
        interop.from_flax_variables("SimpleCNN", bad, (32, 32))
    bad = jax.tree.map(np.copy, tree)
    bad["params"]["Conv_9"] = bad["params"]["Conv_0"]
    with pytest.raises(ValueError, match="no module"):
        interop.from_flax_variables("SimpleCNN", bad, (32, 32))
    with pytest.raises(ValueError, match="shape mismatch"):  # VGG's first dense layer follows the size
        interop.from_flax_variables("VGG16", variables(flax_module("VGG16"), (32, 32)), (64, 64))


@pytest.mark.parametrize("n,k,s", [(224, 3, 2), (57, 3, 2), (71, 5, 2), (112, 5, 2), (56, 1, 2), (57, 1, 2),
                                   (32, 3, 1), (57, 16, 16), (224, 16, 16), (7, 7, 2)])
def test_same_padding_is_flax_s(n, k, s):
    assert nets.same_padding(n, k, s) == tuple(jax.lax.padtype_to_pads((n,), (k,), (s,), "SAME")[0])


def test_available_architectures_are_the_jax_zoo_s_less_nasnet():
    """NASNetMobile is ported too now (``tests/test_torch_nasnet.py``): the
    names are the JAX registry's, in its order."""
    assert available_architectures() == jreg.available_architectures()


@pytest.mark.parametrize("name", ["preprocess_minus1_1", "preprocess_caffe", "preprocess_torch"])
def test_preprocess_functions_equal_the_jax_package(name):
    x = np.random.default_rng(2).integers(0, 256, (2, 8, 8, 3)).astype(np.float32)
    np.testing.assert_array_equal(getattr(registry, name)(x), getattr(jreg, name)(x))
    arch = next(a for a in available_architectures() if registry._ARCHITECTURES[a][1].__name__ == name)
    assert jreg._ARCHITECTURES[arch][1].__name__ == name


def test_register_architecture_extension():
    class Tiny(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.fc = torch.nn.Linear(3, 1000)

        def forward(self, x):
            return self.fc(x.mean(dim=(2, 3)))

    register_architecture("TinyTest", Tiny, lambda v: np.asarray(v, np.float32))
    try:
        clf = load_single_model("TinyTest", shape=(16, 16), device="cpu")
        out = clf[MODEL](np.zeros((1, 16, 16, 3), np.float32))
        assert out.shape == (1, 1000) and out.dtype == np.float32
    finally:
        del registry._ARCHITECTURES["TinyTest"]


def test_deterministic_init_and_the_seed():
    a = load_single_model("SimpleCNN", shape=(32, 32), device="cpu")
    b = load_single_model("SimpleCNN", shape=(32, 32), device="cpu")
    x = np.random.default_rng(1).normal(size=(1, 32, 32, 3)).astype(np.float32)
    np.testing.assert_array_equal(a[MODEL](x), b[MODEL](x))
    import hashlib

    for name in ("SimpleCNN", "MobileNetV2"):  # the JAX registry's seed rule (registry.py:113)
        assert registry.seed_for(name) == int.from_bytes(hashlib.sha256(name.encode()).digest()[:4], "little")


@pytest.mark.parametrize("arch", ["MobileNetV2", "ViTTiny16"])
def test_zoo_forward_at_the_default_dtype(arch):
    """The registry's models (bfloat16 compute) give finite float32 logits."""
    clf = load_single_model(arch, shape=(32, 32), device="cpu")
    batch = np.random.default_rng(0).integers(0, 256, (2, 32, 32, 3)).astype(np.float32)
    logits = clf[MODEL](clf[PRE_INP](batch))
    assert logits.shape == (2, 1000) and logits.dtype == np.float32 and np.isfinite(logits).all()
    if arch == "MobileNetV2":
        assert clf[MODEL].module.layers[0].parts[0].dtype == torch.bfloat16  # the stem conv


def test_loading_needs_a_card_or_device_cpu(monkeypatch):
    assert load_single_model("NoSuchNet", device="cpu") is None  # the reference's contract: log and None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_single_model("SimpleCNN", shape=(32, 32))
