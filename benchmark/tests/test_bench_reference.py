"""The plain references against the port's outputs at small sizes on the
CPU (the port's kernels run their plain twins there)."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.lib import frames
from benchmark.reference import haar, icon
from benchmark.reference import mobilenetv2 as ref_net

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


@pytest.mark.parametrize("shape,seed", [((3, 256, 320), 5), ((1, 64, 96), 2**31 + 3)])
def test_haar_roundtrip_equals_the_port(shape, seed):
    from wicca_tpu_torch import QuantSpec, decode, encode

    x = frames.photo_like(shape, seed, "cpu")
    stream = encode(x, levels=5, spec=QuantSpec(base_step=1.0))
    ref = haar.roundtrip(x, 5, 1.0)
    assert torch.equal(stream.ll.double(), ref.ll)
    for got, want in zip(stream.details, ref.details):
        for g, w in zip(got, want):
            assert g.dtype == torch.int8 and torch.equal(g.double(), w)
    assert torch.equal(decode(stream, emit_u8=True), ref.recon)


def test_haar_control_differs():
    x = frames.photo_like((3, 128, 128), 9, "cpu")
    ref, low = haar.roundtrip(x, 5, 1.0), haar.roundtrip(x, 5, 1.0, torch.bfloat16)
    assert not torch.equal(low.recon, ref.recon)


@pytest.mark.parametrize("depth", [2, 3, 5, 6])
def test_icon_equals_the_harness(depth):
    from wicca_tpu_torch.harness.processor import _compute_icon

    x = frames.photo_like((3, 250, 301), depth, "cpu")
    hwc = np.ascontiguousarray(np.moveaxis(x.numpy(), 0, -1))
    got = _compute_icon(hwc, depth, device="cpu")
    assert np.array_equal(got, np.moveaxis(icon.icon(x, depth).numpy(), 0, -1))


@pytest.fixture(scope="module")
def net():
    from wicca_tpu_torch.models import registry

    torch.set_num_threads(2)
    cfg = json.loads((CONFIGS / "mobilenetv2.json").read_text())
    weights = ref_net.make_weights(cfg, 77, "cpu")
    x = torch.rand(2, 224, 224, 3, generator=torch.Generator().manual_seed(3)) * 2 - 1
    want = ref_net.forward(x, weights, cfg)

    def port(dtype):
        m = registry.build(cfg["architecture"], tuple(cfg["input_size"]), dtype=dtype)
        m.load_state_dict(dict(zip(m.state_dict(), weights)))
        with torch.inference_mode():
            return m.eval()(x.permute(0, 3, 1, 2))

    return cfg, x, weights, want, port


def gap(got, want):
    return float(((got - want).abs().amax(dim=1) / want.abs().amax(dim=1)).max())


def test_mobilenetv2_float32_equals_the_port(net):
    cfg, x, weights, want, port = net
    assert gap(port(torch.float32), want) < 1e-5


def test_mobilenetv2_bfloat16_port_within_the_limit_and_fp8_outside(net):
    cfg, x, weights, want, port = net
    assert gap(port(torch.bfloat16), want) < cfg["limits"]["logit_gap"]
    assert gap(ref_net.forward(x, weights, cfg, fp8=True), want) > cfg["limits"]["logit_gap"]
