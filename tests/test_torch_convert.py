"""Keras H5 weights onto the port's zoo (``wicca_tpu_torch.models.convert``)
against the JAX package's converter (``wicca_tpu.models.convert``).

Synthetic H5 files in the legacy Keras weights layout (``layer_names`` /
``weight_names`` attributes, per-layer datasets, the real keras.applications
layer names; the pattern of ``tests/test_convert_weights.py``), with random
arrays of the schema's shapes, are mapped by both packages. Tolerance 0: the
port's state dict equals, leaf for leaf, ``from_flax_variables`` of the JAX
package's mapped tree. The JAX templates come from ``jax.eval_shape`` (no
init runs); VGG's at 32x32, so its first dense layer stays small. No
TensorFlow import.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_dwt97 import one_torch_thread  # noqa: F401 (fixture)
from wicca_tpu.models import convert as jcw
from wicca_tpu_torch.config.constants import MODEL
from wicca_tpu_torch.models import convert as cw
from wicca_tpu_torch.models.interop import from_flax_variables
from wicca_tpu_torch.models.registry import build, load_single_model

h5py = pytest.importorskip("h5py")

SHAPE = {"VGG16": (32, 32), "VGG19": (32, 32)}


def _shape(arch):
    return SHAPE.get(arch, (224, 224))


def _jax_template(arch):
    module = jcw.flax_module_for(arch)()
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), jnp.zeros((1, *_shape(arch), 3), jnp.float32))
    return jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)


def _keras_arrays(variables, fpath, kind, rng):
    """Random Keras-layout arrays matching a Flax param group."""
    node = variables["params"]
    for k in fpath:
        node = node[k]
    if kind == jcw.BN:
        c = node["scale"].shape[0]
        return [rng.normal(size=(c,)).astype(np.float32) for _ in range(3)] + [
            rng.uniform(0.5, 2.0, size=(c,)).astype(np.float32)]
    kernel = node["kernel"]
    shape = np.transpose(kernel, (0, 1, 3, 2)).shape if kind == jcw.DWCONV else kernel.shape
    arrs = [rng.normal(size=shape).astype(np.float32)]
    if "bias" in node:
        arrs.append(rng.normal(size=node["bias"].shape).astype(np.float32))
    return arrs


def _write_keras_h5(path, layers, root=None):
    with h5py.File(path, "w") as f:
        g0 = f.create_group(root) if root else f
        g0.attrs["layer_names"] = [n.encode() for n in layers]
        for name, arrs in layers.items():
            g = g0.create_group(name)
            wnames = [f"{name}/w{i}:0" for i in range(len(arrs))]
            g.attrs["weight_names"] = [w.encode() for w in wnames]
            for w, a in zip(wnames, arrs):
                g.create_dataset(w, data=a)


def _synthetic(arch, tmp_path, extra=(), root=None):
    variables = _jax_template(arch)
    rng = np.random.default_rng(7)
    layers = {kname: _keras_arrays(variables, fpath, kind, rng) for kname, fpath, kind in jcw.SCHEMAS[arch]()}
    layers.update(dict(extra))
    h5 = tmp_path / f"{arch}.h5"
    _write_keras_h5(h5, layers, root)
    return variables, layers, h5


@pytest.mark.parametrize("arch", ["MobileNetV2", "ResNet50", "EfficientNetB0", "DenseNet121", "VGG16", "VGG19"])
def test_both_packages_map_a_file_to_the_same_weights(arch, tmp_path):
    variables, layers, h5 = _synthetic(arch, tmp_path)
    kw = cw.read_keras_h5(h5)
    jkw = jcw.read_keras_h5(h5)
    assert list(kw) == list(jkw) and all(
        all(np.array_equal(a, b) for a, b in zip(kw[n], jkw[n])) for n in kw)
    jtree, jreport = jcw.map_weights(arch, jkw, variables)
    state, report = cw.map_weights(arch, kw, build(arch, _shape(arch)))
    assert report == jreport
    want = from_flax_variables(arch, jtree, _shape(arch))
    assert list(state) == list(want)
    for key, value in want.items():
        assert torch.equal(state[key], value), key
    model = build(arch, _shape(arch))
    model.load_state_dict(state, strict=True)


def test_model_weights_subgroup_and_skip_layers(tmp_path):
    """Full-model H5s nest under model_weights/; EfficientNet's preprocessing
    layers are skipped with a report."""
    extra = (("rescaling", [np.float32(1 / 255.0)]),
             ("normalization", [np.zeros(3, np.float32), np.ones(3, np.float32), np.int64(0)]))
    _, _, h5 = _synthetic("EfficientNetB0", tmp_path, extra, root="model_weights")
    _, report = cw.map_weights("EfficientNetB0", cw.read_keras_h5(h5), build("EfficientNetB0"))
    assert sorted(report["skipped_preprocessing"]) == ["normalization", "rescaling"]
    assert report["unexpected_keras_layers"] == []


def test_wrong_architecture_fails_loudly(tmp_path):
    _, _, h5 = _synthetic("VGG16", tmp_path)
    kw = cw.read_keras_h5(h5)
    with pytest.raises(ValueError, match="missing layers|shape mismatch"):
        cw.map_weights("ResNet50", kw, build("ResNet50"))
    kw_bad = dict(kw)
    for n, _, _ in cw.SCHEMAS["ResNet50"]():
        kw_bad.setdefault(n, [np.zeros((1, 1, 1, 1), np.float32)])
    with pytest.raises(ValueError, match="shape mismatch|expected 4 BN"):
        cw.map_weights("ResNet50", kw_bad, build("ResNet50"))
    with pytest.raises(ValueError, match="no conversion schema"):
        cw.map_weights("SimpleCNN", kw, build("SimpleCNN"))
    with pytest.raises(ValueError, match="missing layers|shape mismatch"):  # NASNet converts (test_torch_nasnet)
        cw.map_weights("NASNetMobile", kw, build("NASNetMobile"))
    assert "NASNetMobile" in cw.convertible_architectures()


def test_coverage_check_catches_missing_modules(monkeypatch):
    """A schema that misses modules must not half-load."""
    arch = "VGG16"
    variables = _jax_template(arch)
    rng = np.random.default_rng(3)
    partial = cw.SCHEMAS[arch]()[:-1]  # drop predictions
    kweights = {kname: _keras_arrays(variables, fpath, kind, rng) for kname, fpath, kind in partial}
    monkeypatch.setitem(cw.SCHEMAS, arch, lambda: partial)
    with pytest.raises(ValueError, match="not covered"):
        cw.map_weights(arch, kweights, build(arch, _shape(arch)))


def test_converted_file_drives_the_registry(tmp_path, monkeypatch):
    """``convert_h5`` writes ``<arch>.msgpack``, the JAX converter's file;
    ``WICCA_TPU_WEIGHTS`` points the registry at it; an unreadable file
    gives None (logged)."""
    arch = "MobileNetV2"
    _, layers, h5 = _synthetic(arch, tmp_path)
    out = cw.convert_h5(arch, h5, tmp_path / "weights")
    assert out == tmp_path / "weights" / f"{arch}.msgpack"
    monkeypatch.setenv("WICCA_TPU_WEIGHTS", str(tmp_path / "weights"))
    info = load_single_model(arch, shape=(64, 64), device="cpu")
    kern = info[MODEL].module.get_submodule("_ConvBN_0.Conv_0").weight.detach().numpy()
    np.testing.assert_array_equal(kern, np.transpose(layers["Conv1"][0], (3, 2, 0, 1)))
    dw = info[MODEL].module.get_submodule("_InvertedResidual_1._ConvBN_1.Conv_0").weight.detach().numpy()
    np.testing.assert_array_equal(dw, np.transpose(layers["block_1_depthwise"][0], (2, 3, 0, 1)))
    logits = info[MODEL](np.zeros((1, 64, 64, 3), np.float32))
    assert logits.shape == (1, 1000) and np.isfinite(logits).all()
    (tmp_path / "weights" / "ResNet50.pt").write_bytes(b"not a state dict")
    assert load_single_model("ResNet50", shape=(32, 32), device="cpu") is None


@pytest.mark.parametrize("arch", ["MobileNetV2", "ResNet50"])
def test_msgpack_output_is_the_jax_converters_file(arch, tmp_path, monkeypatch):
    """``convert_h5`` writes the file the JAX converter
    writes for the same H5: flax restores it to the JAX package's mapped
    tree leaf for leaf (the template here comes from ``eval_shape``, whose
    dicts are key-sorted, so the bytes are compared after a restore), and
    the port's registry reads it back to ``map_weights``' state dict."""
    from flax import serialization

    variables, _, h5 = _synthetic(arch, tmp_path)
    out = cw.convert_h5(arch, h5, tmp_path / "weights")
    jtree, _ = jcw.map_weights(arch, jcw.read_keras_h5(h5), variables)
    restored = serialization.msgpack_restore(out.read_bytes())
    assert jax.tree.structure(restored) == jax.tree.structure(jtree)
    for a, b in zip(jax.tree.leaves(restored), jax.tree.leaves(jtree), strict=True):
        assert a.dtype == np.asarray(b).dtype and np.array_equal(a, b)
    monkeypatch.setenv("WICCA_TPU_WEIGHTS", str(tmp_path / "weights"))
    got = load_single_model(arch, device="cpu")[MODEL].module.state_dict()
    want, _ = cw.map_weights(arch, cw.read_keras_h5(h5), build(arch))
    assert list(got) == list(want) and all(torch.equal(got[k], v) for k, v in want.items())
