"""The port's lifting transforms and color transforms against
``wicca_tpu.core.lifting`` / ``wicca_tpu.core.color`` on the CPU.

Integer wavelets (haar_int, legall5.3/cdf53) and RCT are exact: tolerance 0.
Float wavelets (db2, cdf97/bior4.4) and ICT run the same float32 steps in the
same order, but XLA may contract a product and a sum into one fused
multiply-add where PyTorch rounds twice, so they are held to 1e-4 absolute
on values of image range (a few float32 ulps at 255, and far below the
codec's quantization steps)."""

import numpy as np
import pytest
import torch

from wicca_tpu.core import color as jcolor
from wicca_tpu.core import lifting as jl
from wicca_tpu_torch.core import color as tcolor
from wicca_tpu_torch.core import lifting as tl

INT_WAVELETS = ["haar_int", "legall5.3", "cdf53"]
FLOAT_WAVELETS = ["db2", "cdf97", "bior4.4"]
FLOAT_ATOL = 1e-4


def _signal(shape, wavelet, seed=0):
    rng = np.random.default_rng(seed)
    if wavelet in INT_WAVELETS:
        return rng.integers(-300, 300, size=shape).astype(np.int32)
    return (rng.random(shape) * 300 - 20).astype(np.float32)


def _close(got: torch.Tensor, want, wavelet) -> None:
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    if wavelet in INT_WAVELETS:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=FLOAT_ATOL)


@pytest.mark.parametrize("n", [2, 4, 6, 10, 64])
@pytest.mark.parametrize("wavelet", INT_WAVELETS + FLOAT_WAVELETS)
def test_1d_pairs_match_jax(wavelet, n):
    fwd, inv = tl._WAVELETS_1D[wavelet]
    jfwd, jinv = jl._WAVELETS_1D[wavelet]
    x = _signal((3, n), wavelet, seed=n)
    s, d = fwd(torch.from_numpy(x))
    js, jd = jfwd(x)
    _close(s, js, wavelet)
    _close(d, jd, wavelet)
    _close(inv(s, d), jinv(js, jd), wavelet)
    if wavelet in INT_WAVELETS:
        np.testing.assert_array_equal(inv(s, d).numpy(), x)


@pytest.mark.parametrize("wavelet", INT_WAVELETS + FLOAT_WAVELETS)
def test_2d_level_matches_jax(wavelet):
    x = _signal((2, 18, 28), wavelet, seed=1)
    bands = tl.dwt2_level_lifting(torch.from_numpy(x), wavelet)
    jbands = jl.dwt2_level_lifting(x, wavelet)
    for b, jb in zip(bands, jbands):
        _close(b, jb, wavelet)
    _close(tl.idwt2_level_lifting(*bands, wavelet), jl.idwt2_level_lifting(*jbands, wavelet), wavelet)


@pytest.mark.parametrize("levels", [1, 2, 3])
@pytest.mark.parametrize("wavelet", INT_WAVELETS + FLOAT_WAVELETS)
def test_pyramid_matches_jax(wavelet, levels):
    x = np.random.default_rng(levels).integers(0, 256, (3, 37, 50), dtype=np.uint8)
    pyr = tl.dwt2_lifting(torch.from_numpy(x), levels, wavelet, mode="reflect101")
    jpyr = jl.dwt2_lifting(x, levels, wavelet, mode="reflect101")
    assert pyr.orig_shape == tuple(jpyr.orig_shape) and pyr.levels == levels and pyr.wavelet == wavelet
    _close(pyr.ll, jpyr.ll, wavelet)
    for bands, jbands in zip(pyr.details, jpyr.details):
        for b, jb in zip(bands, jbands):
            _close(b, jb, wavelet)
    rec = tl.idwt2_lifting(pyr)
    _close(rec, jl.idwt2_lifting(jpyr), wavelet)
    if wavelet in INT_WAVELETS:
        np.testing.assert_array_equal(rec.numpy(), x)


def test_registry_and_errors():
    assert tl.lifting_wavelets() == jl.lifting_wavelets()
    assert [tl.is_integer_wavelet(w) for w in tl.lifting_wavelets()] == [
        jl.is_integer_wavelet(w) for w in jl.lifting_wavelets()]
    with pytest.raises(ValueError):
        tl.dwt2_lifting(torch.zeros((8, 8)), 2, "nope")
    with pytest.raises(ValueError):
        tl.dwt2_lifting(torch.zeros((8, 8)), 0)
    tl.register_wavelet("cdf97_copy", tl.cdf97_fwd1d, tl.cdf97_inv1d)
    try:
        assert "cdf97_copy" in tl.lifting_wavelets() and not tl.is_integer_wavelet("cdf97_copy")
        x = torch.from_numpy(_signal((1, 16, 16), "cdf97"))
        pyr = tl.dwt2_lifting(x, 2, "cdf97_copy")
        assert torch.equal(pyr.ll, tl.dwt2_lifting(x, 2, "cdf97").ll)
        # float lifting inverts to float32 rounding, not exactly
        torch.testing.assert_close(tl.idwt2_lifting(pyr), x, rtol=0, atol=1e-3)
    finally:
        del tl._WAVELETS_1D["cdf97_copy"]


def test_rct_matches_jax_and_inverts():
    x = np.random.default_rng(31).integers(0, 256, (2, 3, 40, 56), dtype=np.uint8)
    y = tcolor.rct_fwd(torch.from_numpy(x))
    jy = np.asarray(jcolor.rct_fwd(x))
    assert y.dtype == torch.int32
    np.testing.assert_array_equal(y.numpy(), jy)
    back = tcolor.rct_inv(y)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jcolor.rct_inv(jy)))
    np.testing.assert_array_equal(back.numpy(), x.astype(np.int32))


def test_ict_matches_jax():
    x = np.random.default_rng(32).integers(0, 256, (3, 40, 56), dtype=np.uint8)
    y = tcolor.ict_fwd(torch.from_numpy(x))
    jy = np.asarray(jcolor.ict_fwd(x))
    np.testing.assert_allclose(y.numpy(), jy, rtol=0, atol=FLOAT_ATOL)
    np.testing.assert_allclose(tcolor.ict_inv(y).numpy(), np.asarray(jcolor.ict_inv(jy)), rtol=0,
                               atol=FLOAT_ATOL)
    np.testing.assert_allclose(tcolor.ict_inv(y).numpy(), x, rtol=0, atol=1e-3)
