"""The port's data-parallel paths in a 2-rank gloo world on the CPU:
``dp_encode_decode_psnr``, ``dp_icons`` and ``depth_sweep_psnr``
(``wicca_tpu_torch.parallel.batch``) against ``wicca_tpu.parallel.batch``
on a 2-device data mesh, ``measure_scaling``'s rows, ``dryrun_multichip(4)``
on the CPU and its device rule, and ``finetune_on_icons(mesh=data 2)``
against the port's single-device trainer and the JAX trainer on a 2-device
``data_mesh``, all three from the JAX trainer's initial variables (carried
with ``models/interop.py``), also on a folder with an unreadable image.

Tolerances: icons bit for bit; PSNR within 1e-4 dB (float32 means of the
same errors in other orders); the trainer as ``tests/test_torch_train.py``
states it for the JAX trainer: each epoch's mean loss within 1e-5 relative
plus 2e-7, the final parameters within 1e-5 of each leaf's largest
magnitude plus 2e-5 (the batch split changes only the order of float32
sums, which Adam can turn into a learning-rate-sized step where a gradient
is near 0). Every rank ends with the same state, bit for bit.
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import _torch_mesh_ranks as R
from tests.test_torch_dwt97 import one_torch_thread  # noqa: F401 (fixture)
from tests.test_torch_train import LOSS_ATOL, LOSS_RTOL, PARAM_ATOL, PARAM_RTOL, carried_init
from tests.test_torch_train import class_folders  # noqa: F401 (fixture)
from tests.test_torch_train import config as train_config
from wicca_tpu.core.quant import QuantSpec
from wicca_tpu.parallel import batch as jbatch
from wicca_tpu.parallel.mesh import data_mesh as jax_data_mesh
from wicca_tpu.parallel.mesh import make_mesh as jax_make_mesh
from wicca_tpu_torch.harness import train as T
from wicca_tpu_torch.models import interop, nets
from wicca_tpu_torch.parallel import run_world

IMAGES = (5, 3, 64, 96)  # N = 5 on 2 ranks: the last image repeats once


@pytest.fixture(scope="module")
def jax_init():
    from wicca_tpu.models import flax_models

    cfg = train_config()
    init = flax_models.SimpleCNN(num_classes=2).init(jax.random.PRNGKey(cfg.seed),
                                                     jnp.zeros((1, cfg.input_size, cfg.input_size, 3), jnp.float32))
    return jax.tree.map(np.asarray, init)


@pytest.fixture(scope="module")
def broken_folders(class_folders, tmp_path_factory):
    """``class_folders`` and one unreadable image, the last of the 17 files;
    the seed-0 permutations put it at positions 8, 6, 8 and 10 of the four
    epochs, so each epoch's batches refill past it."""
    root = tmp_path_factory.mktemp("train_broken") / "ds"
    shutil.copytree(class_folders, root)
    (root / "dark" / "broken.png").write_bytes(b"not an image")
    return root


@pytest.fixture(scope="module")
def world(class_folders, broken_folders, jax_init, tmp_path_factory):
    images = R._img(IMAGES, 30)
    state = interop.carry(jax_init, nets.SimpleCNN(num_classes=2))
    ckpt = tmp_path_factory.mktemp("mesh_ckpt")
    cfg = {k: v for k, v in vars(train_config()).items() if k != "checkpoint_dir"}
    ranks = run_world(R.batch_checks, 2, images, str(class_folders), str(broken_folders), cfg, state, str(ckpt),
                      backend="gloo", device_type="cpu", timeout_s=120)
    return images, ranks, ckpt


def test_dp_encode_decode_psnr_matches_jax(world):
    images, ranks, _ = world
    want = np.asarray(jbatch.dp_encode_decode_psnr(images, 2, QuantSpec(1.0), mesh=jax_make_mesh(data=2)))
    for r in ranks:
        assert r["psnr"].shape == (IMAGES[0],)
        np.testing.assert_allclose(r["psnr"], want, rtol=0, atol=1e-4)


def test_dp_icons_bit_exact(world):
    images, ranks, _ = world
    want = np.asarray(jbatch.dp_icons(images, 2, mesh=jax_make_mesh(data=2)))
    for r in ranks:
        np.testing.assert_array_equal(r["icons"], want)


def test_depth_sweep_psnr(world):
    images, ranks, _ = world
    want = jbatch.depth_sweep_psnr(images, (1, 2), QuantSpec(1.0), mesh=jax_make_mesh(data=2))
    for r in ranks:
        assert set(r["sweep"]) == {1, 2}
        for d in (1, 2):
            assert abs(r["sweep"][d] - want[d]) < 1e-4


def test_measure_scaling_rows(world):
    _, ranks, _ = world
    rows = ranks[0]["scaling"]
    assert rows == ranks[1]["scaling"]  # every rank returns the same rows
    assert [(r["devices"], r["mesh"]) for r in rows] == [(1, "1x1"), (2, "2x1")]
    assert rows[0]["efficiency"] == 1.0 and all(r["mp_s"] > 0 for r in rows)
    assert all("not meaningful" in r["note"] for r in rows)


def test_dryrun_multichip_on_gloo(monkeypatch):
    from wicca_tpu_torch.entry import dryrun_multichip

    ranks = dryrun_multichip(4, device_type="cpu")
    assert len(ranks) == 4
    for out in ranks:
        assert out["bior44_psnr_db"] > 20.0 and out["haar_psnr_db"] > 40.0 and np.isfinite(out["dp_loss"])
        assert max(out[f"{k}_max_abs_err"] for k in ("tp", "pp", "ep")) <= 1e-5
        assert out["launches"] == {}  # the plain twins on the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device_type='cpu'"):
        dryrun_multichip(4)  # the device rule: None is CUDA, and there is no card


def test_finetune_over_a_data_mesh(world, jax_init, class_folders, monkeypatch):
    _, ranks, ckpt = world
    (state0, info0), (state1, _) = ranks[0]["train"], ranks[1]["train"]
    assert list(state0) == list(state1) and all(np.array_equal(state0[k], state1[k]) for k in state0)
    assert sorted(p.name for p in ckpt.iterdir()) == ["step_2", "step_4", "step_6", "step_8"]  # rank 0 wrote them

    from wicca_tpu.harness import train as JT

    params, jinfo = JT.finetune_on_icons(class_folders, JT.TrainConfig(**vars(train_config())),
                                         mesh=jax_data_mesh(jax.devices()[:2]))
    monkeypatch.setattr(T, "init_model", carried_init(jax_init))
    single, sinfo = T.finetune_on_icons(class_folders, train_config(), device="cpu")
    got_loss = np.array([h["loss"] for h in info0["history"]])
    for other in (jinfo, sinfo):
        want_loss = np.array([h["loss"] for h in other["history"]])
        np.testing.assert_allclose(got_loss, want_loss, rtol=LOSS_RTOL, atol=LOSS_ATOL)
    model = nets.SimpleCNN(num_classes=2)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state0.items()})
    got = interop.to_flax_variables(model)["params"]
    for want in (jax.tree.map(np.asarray, params)["params"], interop.to_flax_variables(
            _loaded(single))["params"]):
        for layer, leaves in want.items():
            for leaf, w in leaves.items():
                bound = PARAM_RTOL * float(np.abs(w).max()) + PARAM_ATOL
                assert float(np.abs(got[layer][leaf] - w).max()) <= bound, (layer, leaf)


def test_finetune_over_a_data_mesh_skips_an_unreadable_image(world, broken_folders):
    """An unreadable image is skipped and each global batch filled from the
    next images, as the JAX trainer on a 2-device ``data_mesh`` does: the
    same losses (two steps an epoch) and parameters, the same on both
    ranks."""
    _, ranks, _ = world
    (state0, info0), (state1, info1) = ranks[0]["train_broken"], ranks[1]["train_broken"]
    assert all(np.array_equal(state0[k], state1[k]) for k in state0)
    assert [h["loss"] for h in info0["history"]] == [h["loss"] for h in info1["history"]]

    from wicca_tpu.harness import train as JT

    params, jinfo = JT.finetune_on_icons(broken_folders, JT.TrainConfig(**vars(train_config())),
                                         mesh=jax_data_mesh(jax.devices()[:2]))
    np.testing.assert_allclose([h["loss"] for h in info0["history"]], [h["loss"] for h in jinfo["history"]],
                               rtol=LOSS_RTOL, atol=LOSS_ATOL)
    model = nets.SimpleCNN(num_classes=2)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state0.items()})
    got = interop.to_flax_variables(model)["params"]
    for layer, leaves in jax.tree.map(np.asarray, params)["params"].items():
        for leaf, w in leaves.items():
            bound = PARAM_RTOL * float(np.abs(w).max()) + PARAM_ATOL
            assert float(np.abs(got[layer][leaf] - w).max()) <= bound, (layer, leaf)


def _loaded(state):
    model = nets.SimpleCNN(num_classes=2)
    model.load_state_dict(state)
    return model
