"""The port reads and writes the JAX package's weight files
(``wicca_tpu_torch.models.flax_msgpack``) and its registry loads them.

* The writer gives the bytes of ``flax.serialization.to_bytes`` for the JAX
  registry's SimpleCNN variables and for trees with every leaf kind flax
  writes (int32, numpy scalars, bfloat16, complex, chunked arrays), and the
  reader restores every leaf and dtype of ``flax.serialization.msgpack_restore``
  (bfloat16 bit for bit, as ``torch.bfloat16``).
* On a ``WICCA_TPU_WEIGHTS`` directory that holds only ``.msgpack`` files,
  the port's logits equal the JAX registry's within the float32 tolerance of
  ``tests/test_torch_models.py`` (1e-5 of the largest |logit|), and
  ``analyze`` through both command lines writes the same CSV bytes.
* Where ``.msgpack`` and ``.pt`` differ, the port follows the ``.msgpack``,
  as the JAX package reads it; a ``.msgpack`` that misses a layer gives
  ``None``, logged, in both packages (one with a leaf of the wrong shape:
  ``None`` in the port, a model that raises at its first call in the JAX
  package).
"""

import logging

import ml_dtypes
import numpy as np
import pytest
import torch
from flax import serialization

from tests.test_torch_cli import both as cli_both
from tests.test_torch_cli import same_files, workdir  # noqa: F401 (fixture)
from tests.test_torch_dwt97 import one_torch_thread  # noqa: F401 (fixture)
from tests.test_torch_models import F32_TOL, assert_logits_close
from wicca_tpu.config.constants import MODEL as JMODEL
from wicca_tpu.models import registry as jreg
from wicca_tpu_torch.config.constants import MODEL, PRE_INP
from wicca_tpu_torch.models import flax_msgpack, interop, registry

SHAPE = (64, 64)


@pytest.fixture(scope="module")
def jax_params():
    """The JAX registry's SimpleCNN variables at 64x64 (its own init; the one
    JAX registry init of this file)."""
    return jreg.load_single_model("SimpleCNN", shape=SHAPE)[JMODEL].params


def as_numpy(tree):
    return {k: as_numpy(v) if isinstance(v, dict) or hasattr(v, "items") else np.asarray(v) for k, v in tree.items()}


@pytest.fixture(scope="module")
def trained(jax_params):
    """Variables no init gives: the registry's, times 1.5, plus 0.01."""
    return {col: _map(lambda a: (a * np.float32(1.5) + np.float32(0.01)).astype(np.float32), sub)
            for col, sub in as_numpy(jax_params).items()}


def _map(fn, tree):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def assert_restored(got, want, path=""):
    """``got`` (the port's reader) holds every key, leaf, dtype and value of
    ``want`` (flax's ``msgpack_restore``)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            assert_restored(got[k], want[k], f"{path}/{k}")
    elif isinstance(got, torch.Tensor):
        w = np.asarray(want)
        assert got.dtype == torch.bfloat16 and w.dtype == ml_dtypes.bfloat16, path
        assert tuple(got.shape) == w.shape, path
        np.testing.assert_array_equal(got.view(torch.int16).numpy(), w.view(np.int16), err_msg=path)
    else:
        assert type(got) is type(want), (path, type(got), type(want))
        if isinstance(want, (np.ndarray, np.generic)):
            assert got.dtype == want.dtype and np.shape(got) == np.shape(want), path
            np.testing.assert_array_equal(got, want, err_msg=path)
        else:
            assert got == want, path


def leaf_kinds():
    rng = np.random.default_rng(3)
    return {
        "params": {
            "kernel": rng.standard_normal((3, 3, 2, 4)).astype(np.float32),
            "counts": np.arange(-70, 230, dtype=np.int32).reshape(3, 100),
            "step": np.int64(-40000),
            "scale": np.float32(0.125),
            "half": rng.standard_normal((5, 7)).astype(ml_dtypes.bfloat16),
            "half_scalar": ml_dtypes.bfloat16(1.5),
            "empty": np.zeros((0, 3), np.float16),
            "flags": np.array([True, False]),
        },
        "meta": {"name": "x" * 40, "n": 7, "neg": -200, "big": 70000, "rate": 0.25, "ok": True, "none": None,
                 "z": 3 + 4j, "wide": {str(i): np.zeros((i,), np.uint8) for i in range(18)}},
        "list": [np.int8(3), np.ones((2,), np.float64)],
    }


def test_writer_gives_flax_bytes_for_the_registry_variables(jax_params):
    data = serialization.to_bytes(jax_params)
    assert flax_msgpack.write(as_numpy(jax_params)) == data
    assert_restored(flax_msgpack.read(data), serialization.msgpack_restore(data))


def test_writer_and_reader_match_flax_on_every_leaf_kind():
    tree = leaf_kinds()
    data = serialization.to_bytes(tree)
    assert flax_msgpack.write(tree) == data
    # torch leaves write as the arrays they hold, bfloat16 included
    ported = dict(tree, params=dict(tree["params"]))
    for k in ("kernel", "counts"):
        ported["params"][k] = torch.from_numpy(tree["params"][k])
    ported["params"]["half"] = torch.from_numpy(tree["params"]["half"].view(np.int16)).view(torch.bfloat16)
    assert flax_msgpack.write(ported) == data
    want = serialization.msgpack_restore(data)
    got = flax_msgpack.read(data)
    assert got["params"]["half_scalar"].dtype == torch.bfloat16  # a bfloat16 scalar: a 0-d tensor, exact
    assert got["params"]["half_scalar"].view(torch.int16).item() == np.asarray(
        want["params"].pop("half_scalar")).view(np.int16)
    got["params"].pop("half_scalar")
    assert_restored(got, want)


def test_chunked_leaves(monkeypatch):
    """Arrays above MAX_CHUNK_SIZE bytes are written as flax chunks them
    (a small limit here), and joined again on reading."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(flax_msgpack, "MAX_CHUNK_SIZE", 64)
    rng = np.random.default_rng(4)
    tree = {"a": rng.standard_normal((10, 9)).astype(np.float32), "b": rng.standard_normal(50).astype(
        ml_dtypes.bfloat16), "c": np.arange(16, dtype=np.int32), "d": {"e": rng.integers(0, 9, (3, 33), np.int8)}}
    data = serialization.to_bytes(tree)
    assert b"__msgpack_chunked_array__" in data
    assert flax_msgpack.write(tree) == data
    assert_restored(flax_msgpack.read(data), serialization.msgpack_restore(data))


def test_reader_refuses_what_is_not_a_flax_document():
    data = serialization.to_bytes({"a": np.ones(3, np.float32)})
    with pytest.raises(ValueError, match="ends inside"):
        flax_msgpack.read(data[:-1])
    with pytest.raises(ValueError, match="follow"):
        flax_msgpack.read(data + b"\x00")
    with pytest.raises(ValueError, match="extension type 7"):
        flax_msgpack.read(b"\x81\xa1a\xd4\x07\x00")


def logits_of_both(weights_dir, monkeypatch):
    """(port, JAX) logits of SimpleCNN loaded from ``weights_dir`` on one
    seeded batch."""
    monkeypatch.setenv("WICCA_TPU_WEIGHTS", str(weights_dir))
    x = np.random.default_rng(7).uniform(0, 255, (3, *SHAPE, 3)).astype(np.float32)
    port = registry.load_single_model("SimpleCNN", shape=SHAPE, device="cpu")
    jclf = jreg.load_single_model("SimpleCNN", shape=SHAPE)
    got = port[MODEL](port[PRE_INP](x))
    want = np.asarray(jclf[JMODEL](jclf[PRE_INP](x)))
    return got, want


def test_msgpack_only_directory_gives_the_jax_logits(trained, tmp_path, monkeypatch, caplog):
    (tmp_path / "SimpleCNN.msgpack").write_bytes(serialization.to_bytes(trained))
    with caplog.at_level(logging.WARNING):
        got, want = logits_of_both(tmp_path, monkeypatch)
    assert "No weights file" not in caplog.text
    assert_logits_close(got, want, F32_TOL)
    # the carried state dict is the trained tree, leaf for leaf
    module = registry.load_single_model("SimpleCNN", shape=SHAPE, device="cpu")[MODEL].module
    for k, v in interop.from_flax_variables("SimpleCNN", trained, SHAPE).items():
        assert torch.equal(module.state_dict()[k], v), k


def test_msgpack_wins_over_pt(trained, jax_params, tmp_path, monkeypatch):
    (tmp_path / "SimpleCNN.msgpack").write_bytes(flax_msgpack.write(trained))
    torch.save(interop.from_flax_variables("SimpleCNN", as_numpy(jax_params), SHAPE), tmp_path / "SimpleCNN.pt")
    got, want = logits_of_both(tmp_path, monkeypatch)
    assert_logits_close(got, want, F32_TOL)
    (tmp_path / "SimpleCNN.msgpack").unlink()  # the .pt alone is still read
    monkeypatch.setenv("WICCA_TPU_WEIGHTS", str(tmp_path))
    module = registry.load_single_model("SimpleCNN", shape=SHAPE, device="cpu")[MODEL].module
    assert torch.equal(module.state_dict()["Dense_0.bias"],
                       torch.tensor(np.asarray(jax_params["params"]["Dense_0"]["bias"])))


@pytest.mark.parametrize("fault", ["missing layer", "wrong shape"])
def test_mismatched_msgpack_gives_none(fault, trained, tmp_path, monkeypatch, caplog):
    """A file that does not fit SimpleCNN: the port logs and gives None,
    never the seeded init. The JAX package does the same for a missing
    layer; a leaf of the wrong shape it loads, and its model raises at its
    first call (flax restores leaves without checking their shapes)."""
    if fault == "missing layer":
        bad = dict(trained, params={k: v for i, (k, v) in enumerate(trained["params"].items()) if i})
    else:
        bad = dict(trained, params=dict(trained["params"], Dense_0={"kernel": trained["params"]["Dense_0"]["kernel"],
                                                                      "bias": np.zeros(7, np.float32)}))
    (tmp_path / "SimpleCNN.msgpack").write_bytes(serialization.to_bytes(bad))
    monkeypatch.setenv("WICCA_TPU_WEIGHTS", str(tmp_path))
    with caplog.at_level(logging.ERROR):
        jclf = jreg.load_single_model("SimpleCNN", shape=SHAPE)
        jax_log = caplog.text
        caplog.clear()
        assert registry.load_single_model("SimpleCNN", shape=SHAPE, device="cpu") is None
    assert "Error loading" in caplog.text
    if fault == "missing layer":
        assert jclf is None and "Error loading" in jax_log
    else:
        with pytest.raises(Exception, match="shape"):
            jclf[JMODEL](np.zeros((1, *SHAPE, 3), np.float32))


def test_analyze_on_a_msgpack_only_directory(workdir, trained, capsys, monkeypatch):  # noqa: F811
    """``analyze`` through ``python -m wicca_tpu`` and ``python -m
    wicca_tpu_torch --device cpu`` on one weights directory that holds only
    the JAX package's file: the same CSV bytes."""
    weights = workdir / "msgpack_only"
    weights.mkdir()
    (weights / "SimpleCNN.msgpack").write_bytes(serialization.to_bytes(trained))
    monkeypatch.setenv("WICCA_TPU_WEIGHTS", str(weights))
    assert cli_both(capsys, workdir, "analyze", "{in}/imgs", "--models", "SimpleCNN", "--depths", "1", "2",
                    "--input-size", "64", "--results-folder", "{out}/res_msgpack", "--quiet")[0] == 0
    for depth in (1, 2):
        same_files(workdir, *(f"res_msgpack/depth-{depth}/{f}" for f in
                              (f"SimpleCNN-depth-{depth}.csv", f"SimpleCNN-summary-depth-{depth}.csv")))
