"""The port's NASNets against the JAX package's: the checkpoint graph
(``wicca_tpu_torch.models.nasnet_keras.NASNetMobileKeras``, the registry's
and the converter's NASNetMobile) and the paper cells
(``wicca_tpu_torch.models.nets.NASNetMobile``).

Each graph at a small config (penultimate_filters=192, one cell per stack,
10 classes), its Flax variable tree filled with seeded numpy values and
carried across by ``models/interop.py``, on one odd and one even input size
(Keras's ``correct_pad`` and Flax's 'SAME' both depend on the parity).
Tolerances as ``tests/test_torch_models.py`` states them, relative to the
largest |logit| of the JAX model: float32 within 1e-5, bfloat16 within
2e-2. The converter maps a synthetic Keras H5 of the full 224x224 model to
exactly the JAX converter's weights (tolerance 0).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_dwt97 import one_torch_thread  # noqa: F401 (fixture)
from tests.test_torch_models import BF16_TOL, F32_TOL, assert_logits_close, variables
from wicca_tpu.models import convert as jcw
from wicca_tpu.models import flax_models as fm
from wicca_tpu.models import registry as jreg
from wicca_tpu.models.nasnet_keras import NASNetMobileKeras as JaxKeras
from wicca_tpu_torch.models import convert as cw
from wicca_tpu_torch.models import interop, nets, registry
from wicca_tpu_torch.models.nasnet_keras import NASNetMobileKeras

SMALL = {"keras": (JaxKeras, NASNetMobileKeras, dict(penultimate_filters=192, num_blocks=1, num_classes=10)),
         "paper": (fm.NASNetMobile, nets.NASNetMobile, dict(penultimate_filters=192, cells_per_stack=1,
                                                             num_classes=10))}
SHAPES = {"odd": (33, 47), "even": (32, 48)}


@pytest.fixture(scope="module")
def jax_side():
    """(tree, input, JAX logits) per (graph, size, dtype), made once."""
    cache = {}

    def get(graph, size, dtype):
        key = (graph, size, dtype)
        if key not in cache:
            jcls, _, kw = SMALL[graph]
            module = jcls(**kw, dtype=getattr(jnp, dtype))
            shape = SHAPES[size]
            tree = variables(module, shape, seed=2)
            x = np.random.default_rng(3).uniform(-1, 1, (2, *shape, 3)).astype(np.float32)
            cache[key] = tree, x, np.asarray(jax.jit(module.apply)(tree, jnp.asarray(x)))
        return cache[key]

    return get


def port_logits(graph, size, dtype, tree, x):
    _, tcls, kw = SMALL[graph]
    model = tcls(**kw, dtype=getattr(torch, dtype), image_size=SHAPES[size]).eval()
    model.load_state_dict(interop.carry(tree, model), strict=True)
    with torch.inference_mode():
        return model(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()


@pytest.mark.parametrize("size", list(SHAPES))
@pytest.mark.parametrize("graph", list(SMALL))
def test_logits_equal_jax_at_float32(jax_side, graph, size):
    tree, x, want = jax_side(graph, size, "float32")
    assert_logits_close(port_logits(graph, size, "float32", tree, x), want, F32_TOL)


@pytest.mark.parametrize("graph", list(SMALL))
def test_logits_equal_jax_at_bfloat16(jax_side, graph):
    tree, x, want = jax_side(graph, "odd", "bfloat16")
    assert_logits_close(port_logits(graph, "odd", "bfloat16", tree, x), want, BF16_TOL)


@pytest.mark.parametrize("graph", list(SMALL))
def test_flax_names_carry_across(graph):
    """Every Flax path is a state dict entry and back: the Keras layer names
    of the checkpoint graph, and Flax's creation-order names of the paper
    cells (``_adjust``'s convs before the cell's own, each ``_sep_block``
    making Conv, Conv, BatchNorm twice)."""
    jcls, tcls, kw = SMALL[graph]
    shapes = jax.eval_shape(jcls(**kw).init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 48, 3)))
    want = {jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    back = interop.to_flax_variables(tcls(**kw, image_size=(32, 48)))
    assert {jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(back)[0]} == want
    if graph == "paper":
        cell = tcls(**kw, image_size=(32, 48))._ReductionCellA_1  # filters 4; a factorized adjust
        assert cell.Conv_0.weight.shape == cell.Conv_1.weight.shape == (2, 32, 1, 1)  # both read p, the stem's 32
        assert cell.BatchNorm_0.weight.shape == (4,)  # the adjust's, made after its two convs
        assert cell.Conv_2.weight.shape == (4, 8, 1, 1)  # the cell's 1x1 on x (4 x 2 channels)
        assert cell.Conv_3.weight.shape == (4, 1, 5, 5) and cell.Conv_3.groups == 4  # then _sep_block's depthwise
        assert cell.Conv_4.weight.shape == (4, 4, 1, 1) and cell.BatchNorm_2.weight.shape == (4,)
    else:
        model = tcls(**kw, image_size=(32, 48))
        assert model.separable_conv_1_normal_left1_0.Conv_0.groups > 1
        assert {"stem_conv1", "adjust_bn_stem_2", "predictions"} <= set(dict(model.named_children()))


def test_parameter_counts_at_224():
    """The Keras graph's params hold 5,289,978 values (plus 36,738 BatchNorm
    statistics), as JAX's do; the paper graph's tree equals JAX's."""
    for jmodule, arch_or_cls in ((JaxKeras(), "NASNetMobile"), (fm.NASNetMobile(), nets.NASNetMobile)):
        shapes = jax.eval_shape(jmodule.init, jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)))
        with torch.device("meta"):
            model = registry.build(arch_or_cls) if isinstance(arch_or_cls, str) else arch_or_cls()
        state = model.state_dict()
        for col, keys in (("params", [k for k in state if "running_" not in k]),
                          ("batch_stats", [k for k in state if "running_" in k])):
            assert sum(state[k].numel() for k in keys) == sum(
                int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes[col]))
    assert sum(v.numel() for k, v in registry.build("NASNetMobile").state_dict().items()
               if "running_" not in k) == 5_289_978


def test_a_path_the_build_did_not_take_raises():
    """Flax picks each ``adjust`` path from the input's height at every call;
    the port builds the path of its ``image_size`` and refuses another."""
    _, tcls, kw = SMALL["paper"]
    model = tcls(**kw, image_size=(32, 32))
    with pytest.raises(ValueError, match="image_size"):
        model(torch.zeros(1, 3, 2, 64))


def test_registry_and_converter_names_equal_the_jax_package_s():
    assert registry.available_architectures() == jreg.available_architectures() + ("SwinL384", "MaxViTXL512")
    assert cw.convertible_architectures() == jcw.convertible_architectures()
    assert registry._ARCHITECTURES["NASNetMobile"][0] is NASNetMobileKeras
    assert registry._ARCHITECTURES["NASNetMobile"][1].__name__ == jreg._ARCHITECTURES["NASNetMobile"][1].__name__


def test_keras_h5_maps_to_the_jax_converter_s_weights(tmp_path):
    pytest.importorskip("h5py")
    from tests.test_torch_convert import _jax_template, _keras_arrays, _write_keras_h5

    variables_ = _jax_template("NASNetMobile")
    rng = np.random.default_rng(7)
    layers = {}
    for kname, fpath, kind in jcw.SCHEMAS["NASNetMobile"]():
        if kind == jcw.SEPCONV:  # Keras stores [depthwise (kh, kw, C, 1), pointwise (1, 1, C, F)]
            node = variables_["params"][fpath[0]]
            dw = np.transpose(node["Conv_0"]["kernel"], (0, 1, 3, 2)).shape
            layers[kname] = [rng.normal(size=s).astype(np.float32) for s in (dw, node["Conv_1"]["kernel"].shape)]
        else:
            layers[kname] = _keras_arrays(variables_, fpath, kind, rng)
    h5 = tmp_path / "NASNetMobile.h5"
    _write_keras_h5(h5, layers)
    kw = cw.read_keras_h5(h5)
    jtree, jreport = jcw.map_weights("NASNetMobile", jcw.read_keras_h5(h5), variables_)
    state, report = cw.map_weights("NASNetMobile", kw, registry.build("NASNetMobile"))
    assert report == jreport and report["converted"] == len(cw.SCHEMAS["NASNetMobile"]())
    want = interop.from_flax_variables("NASNetMobile", jtree)
    assert list(state) == list(want)
    for key, value in want.items():
        assert torch.equal(state[key], value), key


def test_to_flax_variables_inverts_the_carry():
    jcls, tcls, kw = SMALL["keras"]
    tree = variables(dataclasses.replace(jcls(**kw), dtype=jnp.float32), (33, 47), seed=5)
    model = tcls(**kw, image_size=(33, 47))
    model.load_state_dict(interop.carry(tree, model), strict=True)
    back = dict(jax.tree_util.tree_flatten_with_path(interop.to_flax_variables(model))[0])
    want = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    assert set(map(jax.tree_util.keystr, back)) == set(map(jax.tree_util.keystr, want))
    got = {jax.tree_util.keystr(k): v for k, v in back.items()}
    for k, v in want.items():
        np.testing.assert_array_equal(got[jax.tree_util.keystr(k)], v)
