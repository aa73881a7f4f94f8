"""The port's icon fine-tuning (``wicca_tpu_torch.harness.train``) against
the JAX package's (``wicca_tpu.harness.train``), on the CPU.

* SimpleCNN (float32) on the dark/bright ImageFolder of ``tests/test_train.py``
  through both ``finetune_on_icons``, the port starting from the JAX
  trainer's own init (``jax.random.PRNGKey(seed)``) carried across: the same
  icons, resizes and epoch order go in, so the two differ only in the
  order of float32 sums (convolutions, their gradients, the loss) and in
  Adam's roundings. Stated tolerances: each epoch's mean loss within 1e-5 of
  the JAX trainer's (relative) plus 2e-7 (two float32 steps at 1: a
  confident prediction's cross-entropy, ``-log p`` with ``p`` near 1, is
  resolved no finer, and the last epoch's loss here is 5e-4); the final parameters within 1e-5 of each
  leaf's largest magnitude plus 2e-5 absolute. Adam divides a gradient by
  its own root mean square, so a float32 difference in a gradient near 0
  becomes a difference of up to the learning rate (3e-3) in that step's
  update; 2e-5 is under 1% of one such flip.
* MobileNetV2 (float32, 32x32, 2 classes), two steps of the JAX trainer's
  step (``jax.value_and_grad`` over the whole variable tree, ``optax.adam``)
  and of the port's ``train_step`` on the same batches from the same
  weights: the BatchNorm running statistics move as JAX's do. Stated
  tolerance: each element within 1e-6 plus 1e-4 of its leaf's largest move
  (about 2 x lr = 2e-3), but for at most 1e-3 of the elements, which may
  differ by up to 4 x lr: Adam's first steps are ``g / |g|`` where ``|g|``
  exceeds eps (1e-8), so a gradient within float32 noise of 0 or of eps
  moves anywhere within the learning rate (measured: 4 of 34,112 elements,
  the largest 3.1e-5).
"""

import numpy as np
import pytest
import torch

from tests.test_torch_dwt97 import one_torch_thread  # noqa: F401 (fixture)
from wicca_tpu_torch.harness import train as T
from wicca_tpu_torch.models import interop, nets

LOSS_RTOL, LOSS_ATOL = 1e-5, 2e-7
PARAM_RTOL, PARAM_ATOL = 1e-5, 2e-5


@pytest.fixture(scope="module")
def class_folders(tmp_path_factory):
    cv2 = pytest.importorskip("cv2")
    root = tmp_path_factory.mktemp("train_ds")
    rng = np.random.default_rng(0)
    for cname, base in (("dark", 40), ("bright", 200)):  # tests/test_train.py's folder
        (root / cname).mkdir()
        for i in range(8):
            img = np.clip(base + rng.normal(0, 25, (64, 64, 3)), 0, 255).astype(np.uint8)
            cv2.imwrite(str(root / cname / f"{i}.png"), img)
    return root


def config(**kw):
    base = dict(architecture="SimpleCNN", input_size=32, depth=1, batch_size=8, learning_rate=3e-3, epochs=4)
    return T.TrainConfig(**{**base, **kw})


@pytest.fixture(scope="module")
def jax_run(class_folders):
    """The JAX trainer's run and its initial variables."""
    import jax
    import jax.numpy as jnp

    from wicca_tpu.harness import train as JT
    from wicca_tpu.models import flax_models

    cfg = config()
    init = flax_models.SimpleCNN(num_classes=2).init(jax.random.PRNGKey(cfg.seed),
                                                     jnp.zeros((1, cfg.input_size, cfg.input_size, 3), jnp.float32))
    params, info = JT.finetune_on_icons(class_folders, JT.TrainConfig(**vars(cfg)))
    return jax.tree.map(np.asarray, init), jax.tree.map(np.asarray, params), info


def carried_init(tree):
    """``init_model`` holding a Flax variable tree."""
    make = T.init_model

    def init_model(cfg, num_classes):
        model = make(cfg, num_classes)
        model.load_state_dict(interop.carry(tree, model), strict=True)
        return model

    return init_model


def test_finetune_follows_the_jax_trainer(jax_run, class_folders, monkeypatch):
    init, want, jinfo = jax_run
    monkeypatch.setattr(T, "init_model", carried_init(init))
    state, info = T.finetune_on_icons(class_folders, config(), device="cpu")
    assert info["classes"] == jinfo["classes"] == ["bright", "dark"]
    got_loss = np.array([h["loss"] for h in info["history"]])
    want_loss = np.array([h["loss"] for h in jinfo["history"]])
    np.testing.assert_allclose(got_loss, want_loss, rtol=LOSS_RTOL, atol=LOSS_ATOL)
    model = nets.SimpleCNN(num_classes=2)
    model.load_state_dict(state)
    got = interop.to_flax_variables(model)["params"]
    for layer, leaves in want["params"].items():
        for leaf, w in leaves.items():
            g = got[layer][leaf]
            bound = PARAM_RTOL * float(np.abs(w).max()) + PARAM_ATOL
            assert float(np.abs(g - w).max()) <= bound, (layer, leaf, float(np.abs(g - w).max()), bound)


def _mnv2_batches(n_steps=2, bs=4):
    rng = np.random.default_rng(11)
    return [(rng.uniform(-1, 1, (bs, 32, 32, 3)).astype(np.float32), rng.integers(0, 2, bs).astype(np.int32))
            for _ in range(n_steps)]


def test_batchnorm_statistics_train_as_jax_s():
    """The JAX trainer's step (``train.py:106-114``) at float32 against
    ``train_step``; both from the same seeded variables."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    import optax

    from tests.test_torch_models import variables
    from wicca_tpu.models import flax_models

    module = dataclasses.replace(flax_models.MobileNetV2(num_classes=2), dtype=jnp.float32)
    tree = variables(module, (32, 32), seed=3)
    tx = optax.adam(1e-3)

    @jax.jit
    def step(params, opt_state, xb, yb):
        def loss_fn(p):
            return optax.softmax_cross_entropy_with_integer_labels(module.apply(p, xb), yb).mean()

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state2 = tx.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state2, loss

    params, opt_state = tree, tx.init(tree)
    model = nets.MobileNetV2(num_classes=2, dtype=torch.float32)
    model.load_state_dict(interop.carry(tree, model), strict=True)
    opt = T.OptaxAdam(T.trainable(model), 1e-3)
    for xb, yb in _mnv2_batches():
        params, opt_state, jloss = step(params, opt_state, jnp.asarray(xb), jnp.asarray(yb))
        loss = T.train_step(model, opt, torch.from_numpy(xb).permute(0, 3, 1, 2), torch.from_numpy(yb).long())
        assert abs(float(loss) - float(jloss)) <= LOSS_RTOL * abs(float(jloss)) + LOSS_ATOL
    got = interop.to_flax_variables(model)
    want = jax.tree.map(np.asarray, params)
    moves, off, n = [], 0, 0
    for path, w in jax.tree_util.tree_flatten_with_path(want["batch_stats"])[0]:
        g, w0 = got["batch_stats"], tree["batch_stats"]
        for k in path:
            g, w0 = g[k.key], w0[k.key]
        move = float(np.abs(w - w0).max())
        moves.append(move)
        err = np.abs(g - w)
        assert float(err.max()) <= 4 * 1e-3, (path, float(err.max()))
        off += int((err > 1e-6 + 1e-4 * move).sum())
        n += err.size
    assert off <= 1e-3 * n, (off, n)
    assert len(moves) == 104 and max(moves) > 1e-3  # every statistic of the 52 BatchNorms; about 2 x lr


def test_loss_falls(class_folders, tmp_path):
    state, info = T.finetune_on_icons(class_folders, config(checkpoint_dir=str(tmp_path / "ckpt")), device="cpu")
    losses = [h["loss"] for h in info["history"]]
    assert losses[-1] < losses[0]
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == ["step_2", "step_4", "step_6", "step_8"]


def test_checkpoint_roundtrips_bit_for_bit(class_folders, tmp_path):
    cfg = config(architecture="MobileNetV2", epochs=1, checkpoint_dir=str(tmp_path / "ck"))
    state, _ = T.finetune_on_icons(class_folders, cfg, device="cpu")
    back = T.restore_checkpoint(tmp_path / "ck", {"params": state})
    assert back["step"] == 2 and list(back["params"]) == list(state)
    for k, v in state.items():
        assert torch.equal(back["params"][k], v), k
    moved = [k for k in state if k.endswith("running_var") and not torch.equal(state[k], torch.ones_like(state[k]))]
    assert moved  # the statistics were trained
    model = T.init_model(cfg, 2)
    opt = T.OptaxAdam(T.trainable(model), cfg.learning_rate)
    opt.load_state_dict(back["opt_state"])
    saved = back["opt_state"]["state"]
    assert len(saved) == len(state) and all(s["count"] == 2 for s in saved.values())
    for i, s in opt.state_dict()["state"].items():
        assert torch.equal(s["mu"], saved[i]["mu"]) and torch.equal(s["nu"], saved[i]["nu"])
    with pytest.raises(ValueError, match="template"):
        T.restore_checkpoint(tmp_path / "ck", {"params": {"x": torch.zeros(1)}})
    with pytest.raises(FileNotFoundError):
        T.restore_checkpoint(tmp_path / "none")


def test_streaming_loader_holds_one_batch(tmp_path, monkeypatch):
    """The epoch iterator holds at most one batch of decoded pixels (the
    JAX trainer's test, ``tests/test_train.py``)."""
    import cv2

    from wicca_tpu_torch.harness import processor

    root = tmp_path / "ds"
    for cname in ("a", "b"):
        (root / cname).mkdir(parents=True)
        for i in range(7):
            cv2.imwrite(str(root / cname / f"{i}.png"),
                        np.random.default_rng(i).integers(0, 256, (64, 80, 3), dtype=np.uint8))
    files, labels, classes = T._scan_dataset(root)
    assert classes == ["a", "b"] and len(files) == 14
    seen = []
    real = processor._compute_icons_batched

    def spy(images, depth, device=None):
        seen.append(len(images))
        return real(images, depth, device)

    monkeypatch.setattr(processor, "_compute_icons_batched", spy)
    batches = list(T._iter_batches(files, labels, 32, 2, 4, np.arange(len(files)), "cpu"))
    assert len(batches) == 3  # 14 // 4, the trailing partial batch dropped
    for xb, yb in batches:
        assert xb.shape == (4, 32, 32, 3) and xb.dtype == np.float32 and yb.shape == (4,)
    assert seen == [4, 4, 4]


def test_the_device_rule_and_the_mesh(class_folders, monkeypatch):
    """A mesh is a DeviceMesh with a 'data' dim (training over one is
    ``tests/test_torch_parallel_batch.py``'s); anything else raises."""
    with pytest.raises(TypeError, match="DeviceMesh"):
        T.finetune_on_icons(class_folders, config(), mesh=object(), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.finetune_on_icons(class_folders, config())
    with pytest.raises(ValueError, match="batch size"):
        T.finetune_on_icons(class_folders, config(batch_size=32), device="cpu")
