"""The port's mesh codec (``wicca_tpu_torch.parallel.codec``) in an 8-rank
gloo world on the CPU. The cases of ``tests/test_tiled_codec.py`` on its
(1, 2, 4) mesh, each held three ways: against the single-device port,
against ``wicca_tpu.parallel.tiled_encode``'s stream on the same mesh shape
(carried across with ``codec/interop.py``), and on ``.wct`` bytes; then the
Haar, ``haar_int`` and aligned ``legall5.3`` streams on the 4-rank meshes
1x4, 2x2 and 4x1, odd and tile-padded shapes included, bit for bit against
the single-device port and on ``.wct`` bytes.

Tolerances: 0, except the bior4.4 global layout: its codes against the
single-device whole-image lifting of the port within 1 and its LL within
1e-3 (``tests/test_torch_dwt97.py``), and its mesh decode within 1e-2 of
the single-device decode of the same stream (JAX's own bound).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from tests import _torch_mesh_ranks as R
from wicca_tpu.codec import serialize as jax_serialize
from wicca_tpu.core.quant import QuantSpec
from wicca_tpu.parallel import make_mesh as jax_make_mesh
from wicca_tpu.parallel import tiled_encode as jax_tiled_encode
from wicca_tpu_torch.parallel import run_world


@pytest.fixture(scope="module")
def world():
    return run_world(R.codec_checks, 8, backend="gloo", device_type="cpu", timeout_s=120)[0]


@pytest.fixture(scope="module")
def jax_mesh():
    return jax_make_mesh(data=1, ty=2, tx=4)


def _put(x, mesh):
    return jax.device_put(jnp.asarray(x), NamedSharding(mesh, P(*([None] * (x.ndim - 2)), "ty", "tx")))


def _jax_stream(x, mesh, **kw):
    """``wicca_tpu.parallel.tiled_encode`` of ``x`` on ``mesh``, jitted whole
    (one compile, not one per op)."""
    return jax.jit(lambda a: jax_tiled_encode(a, mesh=mesh, **kw))(_put(x, mesh))


def _equal_streams(got: dict, want) -> None:
    """A gathered port stream against a stream (a dict of the port's, or a
    JAX ``CodeStream``), bit for bit."""
    if isinstance(want, dict):
        ll, details = want["ll"], want["details"]
    else:
        ll, details = np.asarray(want.ll), [[np.asarray(b) for b in bands] for bands in want.details]
    assert got["ll"].dtype == ll.dtype and got["ll"].shape == ll.shape
    np.testing.assert_array_equal(got["ll"], ll)
    for gb, wb in zip(got["details"], details, strict=True):
        for g, w in zip(gb, wb, strict=True):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)


def test_tiled_encode_haar_int_matches_single_device(world, jax_mesh):
    x = R._img((3, 64, 128), 0)
    _equal_streams(world["haar_int"], world["haar_int_single"])
    js = _jax_stream(x, jax_mesh, levels=2, wavelet="haar_int")
    _equal_streams(world["haar_int"], js)
    mesh_wct, single_wct = world["haar_int_wct"]
    assert mesh_wct == single_wct == jax_serialize(js)
    np.testing.assert_array_equal(world["haar_int_decode"], x)
    np.testing.assert_array_equal(world["haar_int_tiled_decode"], x)


def test_tiled_encode_haar_lossy_cross_decode(world, jax_mesh):
    x = R._img((1, 64, 128), 1)
    js = _jax_stream(x, jax_mesh, levels=2, spec=QuantSpec(base_step=1.0), wavelet="haar")
    _equal_streams(world["haar"], js)
    mesh_dec, single_dec = world["haar_decode"]
    np.testing.assert_array_equal(mesh_dec, single_dec)
    np.testing.assert_array_equal(world["haar_single_on_mesh"], single_dec)
    assert world["haar_wct"][0] == world["haar_wct"][1] == jax_serialize(js)


def test_tiled_encode_wide_wavelet_global_layout(world):
    """bior4.4 takes the global layout; held against the port's
    single-device whole-image lifting (JAX's mesh bior4.4 is in its slow
    lane) and on bytes."""
    got, want = world["bior44"], world["bior44_global_single"]
    assert got["layout"] == "global"
    np.testing.assert_allclose(got["ll"], want["ll"], rtol=0, atol=1e-3)
    for gb, wb in zip(got["details"], want["details"]):
        for g, w in zip(gb, wb):
            assert g.dtype == w.dtype == np.int16 and int(np.abs(g.astype(np.int32) - w).max()) <= 1
    rec_mesh, rec_single = world["bior44_rec"]
    assert np.abs(rec_mesh - rec_single).max() < 1e-2
    x = R._img((1, 64, 128), 2).astype(np.float64)
    assert 10 * np.log10(255.0**2 / np.mean((rec_mesh - x) ** 2)) > 38.0
    mesh_wct, single_wct = world["bior44_wct"]
    assert mesh_wct == single_wct  # the halo path rounds as the whole-image lifting does


def test_tiled_stream_serializes_with_quality_layers(world, jax_mesh):
    x = R._img((3, 64, 128), 3)
    got = world["layers"]
    js = _jax_stream(x, jax_mesh, levels=2, wavelet="legall5.3", color="rct")
    assert got["layout"] == js.layout == "global"
    _equal_streams(got["stream"], js)
    assert got["blob"] == jax_serialize(js, quality_layers=3)
    np.testing.assert_array_equal(got["full"], x)
    assert got["preview"].shape == x.shape


def test_tiled_haar_stream_bit_identical_with_tile_padding(world, jax_mesh):
    x = R._img((1, 1088, 256), 5)
    assert world["tile_pad"]["shapes"][0] == world["tile_pad_single"]["shapes"][0] == (1, 272, 64)
    _equal_streams(world["tile_pad"], world["tile_pad_single"])
    js = _jax_stream(x, jax_mesh, levels=2, spec=QuantSpec(base_step=1.0), wavelet="haar")
    _equal_streams(world["tile_pad"], js)
    np.testing.assert_array_equal(*world["tile_pad_decode"])


def test_tiled_53_aligned_runs_per_shard_and_matches_single_device(world):
    assert world["aligned_flags"] == (True, False)
    assert world["aligned"]["layout"] == "tiled"
    _equal_streams(world["aligned"], world["aligned_single"])
    np.testing.assert_array_equal(world["aligned_decode"], R._img((1, 1024, 4096), 6))


def test_tiled_53_tiled_layout_stream_falls_back_single_decode(world):
    got, x = world["fallback"]
    np.testing.assert_array_equal(got, x)


def test_tiled_encode_rejects_bad_color(world):
    assert world["bad_color"] == (True, True)


def test_tiled_decode_undoes_roi(world):
    """A maxshift ROI stream decodes on the mesh as on one device (the JAX
    package's ``tiled_decode`` reads ROI codes as plain codes)."""
    np.testing.assert_array_equal(*world["roi"])


def test_decoders_take_a_mesh_stream(world):
    for got, want in world["readers"]:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mesh_key", sorted(R.SMALL_MESHES))
@pytest.mark.parametrize("wavelet,shape,seed,levels", R.IDENTITY_CASES)
def test_streams_bit_identical_on_every_mesh(world, mesh_key, wavelet, shape, seed, levels):
    case = world[f"{mesh_key}_{wavelet}_{shape[1]}"]
    assert case["mesh"]["layout"] == "tiled"  # per-shard kernels (aligned 5/3 on every mesh)
    _equal_streams(case["mesh"], case["single"])
    assert case["wct"][0] == case["wct"][1]
    np.testing.assert_array_equal(*case["decode"])
