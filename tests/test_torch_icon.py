"""The port's icon path against the JAX package: ``HaarCoder.get_small_copy``
on the CPU against ``wicca_tpu.coder.HaarCoder``, the K1 wrapper's plain
path against ``icon_pallas`` in interpret mode, and both against the numpy
oracle. Tolerance 0 throughout."""

import numpy as np
import pytest
import torch

from tests.oracle import oracle_icon
from wicca_tpu.coder import HaarCoder as JaxHaarCoder
from wicca_tpu.ops.dwt_pallas import icon_pallas
from wicca_tpu_torch.coder import HaarCoder
from wicca_tpu_torch.core.pad import pad_to_multiple
from wicca_tpu_torch.ops import dwt_cuda

MODES = ["replicate", "constant", "reflect", "reflect101", "wrap"]
CV2_MODES = {0: "constant", 1: "replicate", 2: "reflect", 3: "wrap", 4: "reflect101"}


def _u8(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, size=shape, dtype=np.uint8)


@pytest.mark.parametrize("depth", [1, 2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("border", [0, 1, 2, 3, 4])
def test_get_small_copy_matches_jax_and_oracle(depth, border):
    img = _u8((37, 53, 3), seed=depth * 7 + border)
    got = HaarCoder().get_small_copy(img, depth, border, 11, device="cpu")
    want = JaxHaarCoder().get_small_copy(img, depth, border, 11)
    assert isinstance(got, np.ndarray) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, oracle_icon(img, depth, CV2_MODES[border], 11))


@pytest.mark.parametrize("mode", MODES)
def test_get_small_copy_mode_strings_and_grayscale(mode):
    img = _u8((29, 31), seed=3)
    got = HaarCoder().get_small_copy(img, 3, mode, 5, device="cpu")
    assert got.shape == (4, 4)
    np.testing.assert_array_equal(got, oracle_icon(img, 3, mode, 5))


def test_get_small_copy_tensor_in_tensor_out():
    img = _u8((40, 24, 3), seed=4)
    got = HaarCoder().get_small_copy(torch.from_numpy(img), 2)
    assert isinstance(got, torch.Tensor) and tuple(got.shape) == (10, 6, 3)
    np.testing.assert_array_equal(got.numpy(), oracle_icon(img, 2))


@pytest.mark.parametrize("depth", [1, 2, 3, 4, 5, 6, 7, 8])
def test_icon_plain_matches_icon_pallas_batched_odd(depth):
    # batched leading dims and odd H, W (padded with pad_to_multiple first)
    x = _u8((2, 3, 61, 83), seed=depth)
    got = dwt_cuda.icon(pad_to_multiple(torch.from_numpy(x), 1 << depth), depth)
    want = np.asarray(icon_pallas(x, depth))
    assert tuple(got.shape) == want.shape == (2, 3, -(-61 // (1 << depth)), -(-83 // (1 << depth)))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("depth", [6, 7])
def test_icon_plain_saturated_blocks(depth):
    # all-255 and all-0 blocks: the clip and the largest exact sums
    x = np.zeros((1, 256, 256), np.uint8)
    x[:, :128] = 255
    want = np.asarray(icon_pallas(x, depth))
    np.testing.assert_array_equal(dwt_cuda.icon_plain(torch.from_numpy(x), depth).numpy(), want)


def test_icon_wrapper_checks():
    x = torch.zeros((3, 24, 24), dtype=torch.uint8)
    with pytest.raises(ValueError):
        dwt_cuda.icon(x, 4)  # 24 is not a multiple of 16
    with pytest.raises(ValueError):
        dwt_cuda.icon(x.float(), 2)
    with pytest.raises(ValueError):
        dwt_cuda.icon(x, 0)
