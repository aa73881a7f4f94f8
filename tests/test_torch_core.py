"""The port's plain-PyTorch core against ``wicca_tpu.core``: padding, Haar
transform, icon chain and quantizers. Inputs come from numpy with a seed;
the tolerance is 0 (bit-exact) unless a test says otherwise."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from wicca_tpu.core import haar as jhaar
from wicca_tpu.core import metrics as jmetrics
from wicca_tpu.core import pad as jpad
from wicca_tpu.core import quant as jquant
from wicca_tpu_torch.core import haar as thaar
from wicca_tpu_torch.core import metrics as tmetrics
from wicca_tpu_torch.core import pad as tpad
from wicca_tpu_torch.core import quant as tquant
from wicca_tpu_torch.data.loader import from_planar, to_planar
from wicca_tpu_torch.data.validation import validate_image

MODES = ["replicate", "constant", "reflect", "reflect101", "wrap"]


def _u8(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, size=shape, dtype=np.uint8)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _same(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("hw", [(1, 1), (1, 2), (2, 3), (3, 1), (3, 3), (5, 7)])
@pytest.mark.parametrize("ratio", [4, 8])
def test_pad_matches_jnp_pad(mode, hw, ratio):
    # pads wider than the dimension included: numpy repeats reflections
    x = _u8((2,) + hw, seed=hw[0] * 10 + hw[1])
    _same(tpad.pad_to_multiple(_t(x), ratio, mode, constant=9), jpad.pad_to_multiple(x, ratio, mode, constant=9))


@pytest.mark.parametrize("enum, mode", [(0, "constant"), (1, "replicate"), (2, "reflect"), (3, "wrap"), (4, "reflect101")])
def test_border_enums(enum, mode):
    assert tpad.normalize_border_mode(enum) == jpad.normalize_border_mode(enum) == mode


def test_border_errors_and_noop():
    with pytest.raises(ValueError):
        tpad.normalize_border_mode("mirror")
    with pytest.raises(ValueError):
        tpad.normalize_border_mode(9)
    with pytest.raises(TypeError):
        tpad.normalize_border_mode(1.0)
    x = _t(_u8((3, 16, 32)))
    assert tpad.pad_to_multiple(x, 8) is x
    assert tpad.pad_amounts(13, 17, 8) == jpad.pad_amounts(13, 17, 8)
    assert tuple(tpad.unpad(x, 5, 7).shape) == (3, 5, 7)


@pytest.mark.parametrize("levels", [1, 2, 3, 4, 5, 6])
def test_dwt2_idwt2_match_core(levels):
    x = _u8((2, 70, 90), seed=levels)
    jp = jhaar.dwt2(x, levels)
    tp = thaar.dwt2(_t(x), levels)
    _same(tp.ll, jp.ll)
    for jb, tb in zip(jp.details, tp.details):
        for a, b in zip(jb, tb):
            _same(b, a)
    _same(thaar.idwt2(tp), jhaar.idwt2(jp))
    assert tp.levels == levels and tp.orig_shape == jp.orig_shape


@pytest.mark.parametrize("depth", [1, 3, 6, 8])
def test_block_mean_ll_matches_core(depth):
    x = (np.random.default_rng(depth).random((2, 256, 256)) * 255).astype(np.float32)
    _same(thaar.block_mean_ll(_t(x), depth), jhaar.block_mean_ll(x, depth))


@pytest.mark.parametrize("depth", [1, 2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("mode", ["replicate", "reflect101"])
def test_haar_icon_matches_core(depth, mode):
    x = _u8((3, 45, 77), seed=depth)
    _same(thaar.haar_icon(_t(x), depth, mode=mode), jhaar.haar_icon(x, depth, mode=mode))


def test_haar_icon_float_input():
    x = (np.random.default_rng(5).random((1, 33, 40)) * 300 - 20).astype(np.float32)
    _same(thaar.haar_icon(_t(x), 3), jhaar.haar_icon(x, 3))


@pytest.mark.parametrize("step", [1.0, 0.75, 2.5])
def test_deadzone_quantizers_match_core(step):
    c = ((np.random.default_rng(1).random((4, 33)) - 0.5) * 300).astype(np.float32)
    q = tquant.quantize_deadzone(_t(c), step)
    _same(q, jquant.quantize_deadzone(c, step))
    _same(tquant.quantize_deadzone(_t(c), step, torch.int16), jquant.quantize_deadzone(c, step, jnp.int16))
    for off in (0.5, 0.3):
        _same(tquant.dequantize_deadzone(q, step, offset=off),
              jquant.dequantize_deadzone(np.asarray(q.numpy()), step, offset=off))


@pytest.mark.parametrize("step", [0.25, 0.75, 3.0])
def test_midtread_quantizers_match_core(step):
    c = ((np.random.default_rng(2).random((5, 17)) - 0.5) * 200).astype(np.float32)
    c[0, :4] = np.array([0.5, 1.5, -0.5, 2.5], np.float32) * step  # ties round to even
    q = tquant.quantize_midtread(_t(c), step)
    _same(q, jquant.quantize_midtread(c, step))
    _same(tquant.dequantize_midtread(q, step), jquant.dequantize_midtread(q.numpy(), step))


@pytest.mark.parametrize("level", [1, 2, 4])
def test_quant_spec_steps(level):
    kw = dict(base_step=0.75, level_gain=1.5, hh_gain=2.0)
    assert tquant.QuantSpec(**kw).band_steps(level) == jquant.QuantSpec(**kw).band_steps(level)
    assert tquant.QuantSpec(**kw).detail_step(level) == jquant.QuantSpec(**kw).detail_step(level)
    assert tquant.QuantSpec().coeff_dtype == torch.int32


def test_metrics_match_core():
    a = _u8((3, 40, 50), seed=3)
    b = _u8((3, 40, 50), seed=4)
    # mean over a different summation order: relative 1e-5
    np.testing.assert_allclose(float(tmetrics.mse(_t(a), _t(b))), float(jmetrics.mse(a, b)), rtol=1e-5)
    np.testing.assert_allclose(float(tmetrics.psnr(_t(a), _t(b))), float(jmetrics.psnr(a, b)), rtol=1e-5)
    assert float(tmetrics.psnr(_t(a), _t(a))) == float("inf")


def test_planar_and_validation():
    img = _u8((5, 7, 3))
    p = to_planar(img)
    assert p.shape == (3, 5, 7)
    np.testing.assert_array_equal(from_planar(p), img)
    tp = to_planar(_t(img))
    assert tuple(tp.shape) == (3, 5, 7) and tp.is_contiguous()
    np.testing.assert_array_equal(from_planar(tp).numpy(), img)
    assert from_planar(to_planar(img[..., 0])).shape == (5, 7)
    validate_image(img)
    validate_image(_t(img))
    for bad in (None, np.zeros((0, 4), np.uint8), img.astype(np.float32)):
        with pytest.raises(ValueError):
            validate_image(bad)
