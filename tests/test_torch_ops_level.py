"""The single-level Haar ops K4/K5 of the port (``ops.dwt_level_quant``,
``ops.idwt_level_dequant``) against ``dwt_level_quant_pallas`` /
``idwt_level_dequant_pallas`` (interpret mode) on the CPU: values, dtypes
and the tile-padded shapes, quantized and float. Tolerance 0."""

import numpy as np
import pytest
import torch

from wicca_tpu.ops.dwt_pallas import dwt_level_quant_pallas, idwt_level_dequant_pallas
from wicca_tpu_torch import ops

# (2, 3, 38, 70): batched, one tile; (1, 1100, 96): rows padded to 1536;
# (1, 72, 1100): columns padded to 2048
SHAPES = [(2, 3, 38, 70), (1, 1100, 96), (1, 72, 1100)]
STEPS = [(1.0, True), (0.75, True), (2.5, True), (1.0, False)]  # int8, int16, int8, float details


def _equal(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert got.numpy().dtype == want.dtype and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("step,quantize", STEPS)
@pytest.mark.parametrize("shape", SHAPES)
def test_level_pair_matches_jax(shape, step, quantize):
    x = (np.random.default_rng(len(shape)).random(shape) * 300 - 20).astype(np.float32)
    got = ops.dwt_level_quant(torch.from_numpy(x), step=step, quantize=quantize)
    want = dwt_level_quant_pallas(x, step=step, quantize=quantize)
    for g, w in zip(got, want):
        _equal(g, w)
    rec = ops.idwt_level_dequant(*got, step=step, quantize=quantize)
    _equal(rec, idwt_level_dequant_pallas(*want, step=step, quantize=quantize))


def test_uint8_input_and_unpadded_bands():
    x = np.random.default_rng(3).integers(0, 256, (3, 64, 128), dtype=np.uint8)
    got = ops.dwt_level_quant(torch.from_numpy(x), step=2.0)
    want = dwt_level_quant_pallas(x, step=2.0)
    for g, w in zip(got, want):
        _equal(g, w)
    assert got[1].dtype == torch.int8
    # bands cut to a size that is no tile multiple: K5 pads them itself
    cut = [b[..., :300 // 2, :] for b in ops.dwt_level_quant(torch.from_numpy(
        np.random.default_rng(4).integers(0, 256, (1, 600, 64), dtype=np.uint8)), step=0.75)]
    _equal(ops.idwt_level_dequant(*cut, step=0.75), idwt_level_dequant_pallas(*[c.numpy() for c in cut], step=0.75))


def test_level_ops_refuse_bad_input():
    with pytest.raises(ValueError):
        ops.dwt_level_quant(torch.zeros((1, 7, 8)))
    ll = torch.zeros((1, 4, 4))
    with pytest.raises(ValueError):
        ops.idwt_level_dequant(ll, *(torch.zeros((1, 4, 4), dtype=torch.int32),) * 3)
    with pytest.raises(ValueError):
        ops.idwt_level_dequant(ll, *(torch.zeros((1, 4, 2), dtype=torch.int8),) * 3)
