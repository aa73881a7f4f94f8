"""The port's tiled transforms (``wicca_tpu_torch.parallel.halo`` and
``.tiled``) in an 8-rank gloo world on the CPU, against
``wicca_tpu.parallel`` on the 8 virtual devices of the pytest process, on
the meshes, shapes and seeds of ``tests/test_tiled.py`` and
``tests/test_halo.py``.

Tolerances: 0 wherever the JAX package is exact (the halo shift, icons,
Haar, ``haar_int``, ``legall5.3``, the pixel counts of the statistics);
the float halo path (db2, bior4.4) within ``tests/test_torch_dwt97.py``'s
LL tolerance of JAX's (``atol`` 1e-3: XLA contracts some lifting products
into fused multiply-adds, the port rounds each operation), and its
roundtrip within JAX's own 5e-3 of the input; the statistics' float32 sums
within 1e-3 (mean) and 1e-2 (std) of JAX's, as JAX's test holds them
against numpy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests import _torch_mesh_ranks as R
from wicca_tpu.core.lifting import _shift as jax_shift
from wicca_tpu.core.lifting import dwt2_lifting
from wicca_tpu.parallel.mesh import make_mesh as jax_make_mesh
from wicca_tpu.parallel.tiled import tiled_dwt2, tiled_icon, tiled_stats
from wicca_tpu_torch.parallel import run_world

FLOAT_ATOL = 1e-3  # tests/test_torch_dwt97.py: LL and float32 coefficients


@pytest.fixture(scope="module")
def world():
    return run_world(R.tiled_checks, 8, backend="gloo", device_type="cpu", timeout_s=120)[0]


@pytest.fixture(scope="module")
def jax_meshes():
    assert len(jax.devices()) == 8
    return {k: jax_make_mesh(*v) for k, v in R.TILED_MESHES.items()}


def _jit(fn, x, *args, **kw):
    """A JAX reference call jitted whole (one compile, not one per op)."""
    return jax.jit(lambda a: fn(a, *args, **kw))(x)


def _assert_pyr(got, want, atol=0.0):
    np.testing.assert_allclose(got["ll"], np.asarray(want.ll), rtol=0, atol=atol)
    for gb, wb in zip(got["details"], want.details):
        for g, w in zip(gb, wb):
            np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=atol)


@pytest.mark.parametrize("k", R.HALO_KS)
def test_shift_halo_matches_global_clamped_shift(world, k):
    got, port = world[f"halo{k}"]
    x = np.arange(2 * 64, dtype=np.float32).reshape(2, 64) * 3.1
    np.testing.assert_array_equal(got, np.asarray(jax_shift(jnp.asarray(x), k)))
    np.testing.assert_array_equal(got, port)


def test_shift_halo_wider_than_block_raises(world):
    assert world["halo_too_wide"]


@pytest.mark.parametrize("key,depth,shape", R.ICON_CASES)
def test_tiled_icon_bit_exact(world, jax_meshes, key, depth, shape):
    img = R._img(shape, 9 if shape[1] == 250 else depth)
    want = np.asarray(_jit(tiled_icon, img, depth, mesh=jax_meshes[key]))
    np.testing.assert_array_equal(world[f"icon_{key}_{depth}_{shape[1]}"], want)


@pytest.mark.parametrize("wavelet", ["haar", "haar_int"])
def test_tiled_haar_matches_jax_bit_exact(world, jax_meshes, wavelet):
    img = R._img((3, 128, 256), 4)
    _assert_pyr(world[f"pyr_{wavelet}"], _jit(tiled_dwt2, img, 3, wavelet, mesh=jax_meshes["2x4"]))
    np.testing.assert_array_equal(world[f"rec_{wavelet}"], img.astype(world[f"rec_{wavelet}"].dtype))


def test_tiled_legall53_halo_bit_exact(world, jax_meshes):
    img = R._img((1, 128, 256), 12)
    _assert_pyr(world["pyr_legall5.3"], _jit(tiled_dwt2, img, 3, "legall5.3", mesh=jax_meshes["2x4"]))
    np.testing.assert_array_equal(world["rec_legall5.3"], img.astype(np.int32))


def test_tiled_db2_halo_within_float_tolerance(world, jax_meshes):
    img = R._img((1, 128, 128), 6, np.float32)
    _assert_pyr(world["pyr_db2_2x4"], _jit(tiled_dwt2, img, 2, "db2", mesh=jax_meshes["2x4"]), FLOAT_ATOL)
    np.testing.assert_allclose(world["rec_db2_2x4"], img, atol=5e-3)


@pytest.mark.parametrize("key", ["1x8", "4x2"])
def test_tiled_bior44_halo_within_float_tolerance(world, key):
    """bior4.4 against the single-device lifting (JAX's tiled bior4.4 is in
    its slow lane: a minute of compile per mesh)."""
    img = R._img((1, 128, 128), 6, np.float32)
    _assert_pyr(world[f"pyr_bior4.4_{key}"], _jit(dwt2_lifting, img, 2, "bior4.4"), FLOAT_ATOL)
    np.testing.assert_allclose(world[f"rec_bior4.4_{key}"], img, atol=5e-3)


def test_tiled_roundtrip_odd_shape_wide(world):
    img = R._img((1, 100, 172), 8, np.float32)
    assert world["rec_odd_bior4.4"].shape == img.shape
    np.testing.assert_allclose(world["rec_odd_bior4.4"], img, atol=5e-3)


def test_tiled_stats(world, jax_meshes):
    img = R._img((1, 64, 128), 11)
    want = tiled_stats(img, mesh=jax_meshes["2x4"])  # returns Python floats: not jitted
    got = world["stats"]
    assert abs(got["mean"] - want["mean"]) < 1e-3 and abs(got["std"] - want["std"]) < 1e-2
    assert got["min"] == want["min"] == img.min() and got["max"] == want["max"] == img.max()
    icon = np.asarray(_jit(tiled_icon, img, 1, mesh=jax_meshes["2x4"])).astype(np.float64)
    got = world["stats_dtensor"]  # a DTensor input: each rank reads its shard
    assert abs(got["mean"] - icon.mean()) < 1e-3 and abs(got["std"] - icon.std()) < 1e-2
    assert got["min"] == icon.min() and got["max"] == icon.max()
