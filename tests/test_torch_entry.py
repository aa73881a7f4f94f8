"""The port's flagship forward (``wicca_tpu_torch.entry.entry``) against
``__graft_entry__.entry()``, on the CPU, on the same seeded uint8 batch.

Stated tolerances:
* the preprocessing (pad, depth-2 block-mean LL, bilinear 64 -> 224, then
  ``/127.5 - 1``) within 1e-5 of the JAX entry's: the LL chain is the same
  float32 arithmetic; ``F.interpolate`` and ``jax.image.resize`` weigh the
  same neighbours in other orders;
* the logits, the JAX entry's MobileNetV2 weights carried across, within
  2e-2 of the largest |logit| (bfloat16 compute, the bound of
  ``tests/test_torch_models.py``), the same top-1 where the margin is clear.
"""

import numpy as np
import pytest
import torch

from tests.test_torch_dwt97 import one_torch_thread  # noqa: F401 (fixture)
from tests.test_torch_models import BF16_TOL, assert_logits_close
from wicca_tpu_torch.entry import entry, preprocess
from wicca_tpu_torch.models.interop import from_flax_variables


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(4)
    x = rng.integers(0, 256, (2, 3, 256, 256)).astype(np.float64)
    x[1] = np.clip(128 + 100 * np.sin(np.arange(256) / 9.0)[None, :, None] + rng.normal(0, 20, (3, 256, 256)), 0, 255)
    return x.astype(np.uint8)


def test_preprocessing_equals_the_jax_entry_s(images, monkeypatch):
    import flax.linen as nn

    import __graft_entry__
    from wicca_tpu.models import flax_models

    class Identity(nn.Module):
        @nn.compact
        def __call__(self, x, train: bool = False):
            return x

    monkeypatch.setattr(flax_models, "MobileNetV2", Identity)
    forward, (params, _) = __graft_entry__.entry()
    want = np.asarray(forward(params, images))  # NHWC
    got = preprocess(torch.from_numpy(images)).permute(0, 2, 3, 1).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape == (2, 224, 224, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_logits_equal_the_jax_entry_s(images):
    import __graft_entry__

    jforward, (params, example) = __graft_entry__.entry()
    forward, (model, example_images) = entry(device="cpu")
    assert example_images.shape == example.shape and example_images.dtype == example.dtype
    model.load_state_dict(from_flax_variables("MobileNetV2", params), strict=True)
    got = forward(model, images)
    assert got.shape == (2, 1000) and got.dtype == torch.float32
    assert_logits_close(got.numpy(), np.asarray(jforward(params, images)), BF16_TOL)
    assert torch.isfinite(forward(model, torch.from_numpy(example_images))).all()


def test_entry_needs_a_card_or_device_cpu(monkeypatch):
    forward, (model, _) = entry(device="cpu")
    assert next(model.parameters()).device.type == "cpu" and next(model.parameters()).dtype == torch.float32
    assert model.layers[0].parts[0].dtype == torch.bfloat16  # the stem conv computes in bfloat16
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry()
