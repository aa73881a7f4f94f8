"""The port's lossless codec (legall5.3 / cdf53 / haar_int, with and without
the reversible color transform) and its partial decodes against
``wicca_tpu.codec.pipeline`` on the CPU: LL, every detail plane (values,
dtypes, tile-padded shapes), int32 and uint8 reconstructions,
``decode_at_level``, ``decode_region``, ``icon_from_stream``, streams
crossing between the packages, and ``LiftingCoder``. Tolerance 0, except
the float-wavelet icons of ``LiftingCoder`` (stated there).

Shapes cross the (512, 1024) tile seams in each direction, as the JAX tests
do at ``tests/test_codec.py:446-480``: 1100 rows or columns pad to 1120 at
depth 5 and then to 1536 or 2048 at the first pass."""

import dataclasses

import numpy as np
import pytest
import torch

from tests.test_torch_codec import _assert_streams_equal
from tests.test_torch_codec_streams import _jax_stream
from wicca_tpu.codec import pipeline as jpipe
from wicca_tpu.coder import LiftingCoder as JaxLiftingCoder
from wicca_tpu.core.lifting import dwt2_lifting as jax_dwt2_lifting
from wicca_tpu.core.quant import QuantSpec as JaxQuantSpec
from wicca_tpu_torch import LiftingCoder
from wicca_tpu_torch.codec import pipeline as tpipe
from wicca_tpu_torch.codec.interop import stream_from_arrays, stream_to_arrays
from wicca_tpu_torch.core.quant import QuantSpec

COLORS = {"none": 3, "rct": 3, "rct-rgba": 4}  # color option -> planes


def _u8(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, size=shape, dtype=np.uint8)


def _encode_both(x, levels, wavelet, color="none"):
    ts = tpipe.encode(x, levels=levels, wavelet=wavelet, color=color, device="cpu")
    js = jpipe.encode(x, levels=levels, wavelet=wavelet, color=color)
    return ts, js


def _equal(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _assert_lossless(ts, js, x) -> None:
    """Streams equal (fields, LL, planes) and both decodes equal JAX's and x."""
    _assert_streams_equal(ts, js)
    assert (ts.wavelet, ts.color, ts.layout) == (js.wavelet, js.color, js.layout)
    for emit_u8 in (False, True):
        got = tpipe.decode(ts, emit_u8=emit_u8)
        _equal(got, jpipe.decode(js, emit_u8=emit_u8))
        np.testing.assert_array_equal(got.numpy(), x)


@pytest.mark.parametrize("levels", [1, 2, 3, 4, 5, 6])
def test_lossless_depths_match_jax(levels):
    x = _u8((3, 45, 70), seed=levels)  # divisible by 2**levels for no level here
    ts, js = _encode_both(x, levels, "legall5.3", "rct")
    _assert_lossless(ts, js, x)


@pytest.mark.parametrize("color", COLORS)
@pytest.mark.parametrize("wavelet", ["legall5.3", "cdf53", "haar_int"])
def test_lossless_wavelets_and_colors_match_jax(wavelet, color):
    x = _u8((2, COLORS[color], 37, 50), seed=7)
    ts, js = _encode_both(x, 3, wavelet, color.split("-")[0])
    assert ts.wavelet == ("haar_int" if wavelet == "haar_int" else "legall5.3")
    _assert_lossless(ts, js, x)
    _equal(tpipe.icon_from_stream(ts), jpipe.icon_from_stream(js))


@pytest.mark.parametrize("wavelet", ["legall5.3", "haar_int"])
@pytest.mark.parametrize("shape", [(2, 1100, 96), (1, 72, 1100)])
def test_lossless_across_tile_seams_matches_jax(shape, wavelet):
    x = _u8(shape, seed=shape[1])
    ts, js = _encode_both(x, 5, wavelet)
    _assert_lossless(ts, js, x)
    for target in range(1, 6):
        _equal(tpipe.decode_at_level(ts, target), jpipe.decode_at_level(js, target))


@pytest.mark.parametrize("wavelet", ["legall5.3", "haar_int"])
def test_decode_at_level_rct_matches_jax(wavelet):
    x = _u8((3, 96, 128), seed=15)
    ts, js = _encode_both(x, 4, wavelet, "rct")
    for target in range(0, 5):
        for emit_u8 in (False, True):
            _equal(tpipe.decode_at_level(ts, target, emit_u8=emit_u8),
                   jpipe.decode_at_level(js, target, emit_u8=emit_u8))
    with pytest.raises(ValueError):
        tpipe.decode_at_level(ts, 5)


def test_decode_at_level_haar_matches_jax():
    x = _u8((3, 90, 100), seed=16)
    spec = dict(base_step=0.75, hh_gain=1.5)
    ts = tpipe.encode(x, levels=5, spec=QuantSpec(**spec), device="cpu")
    js = jpipe.encode(x, levels=5, spec=JaxQuantSpec(**spec))
    for target in range(0, 6):
        for emit_u8, off in ((False, 0.3), (True, 0.5)):
            _equal(tpipe.decode_at_level(ts, target, emit_u8=emit_u8, recon_offset=off),
                   jpipe.decode_at_level(js, target, emit_u8=emit_u8, recon_offset=off))


@pytest.mark.parametrize("wavelet", ["legall5.3", "haar_int"])
def test_band_div_widening_matches_jax(wavelet):
    ts, js = _encode_both(_u8((1, 48, 64), seed=10), 4, wavelet)
    div = tuple(int(d) for d in np.random.default_rng(0).integers(1, 4, size=12))
    ts, js = dataclasses.replace(ts, band_div=div), dataclasses.replace(js, band_div=div)
    for emit_u8 in (False, True):
        _equal(tpipe.decode(ts, emit_u8=emit_u8), jpipe.decode(js, emit_u8=emit_u8))
    _equal(tpipe.decode_at_level(ts, 2), jpipe.decode_at_level(js, 2))


REGIONS = {
    # (shape, levels, wavelet): windows (row0, row1, col0, col1)
    "legall-1200-single-pass": ((1, 1200, 96), 2, "legall5.3", [(520, 700, 10, 90)]),
    "legall-1100-multipass": ((1, 1100, 96), 5, "legall5.3",
                              [(520, 700, 10, 90), (0, 40, 0, 96), (1050, 1100, 30, 60)]),
    "legall-wide": ((1, 40, 1100), 4, "legall5.3", [(3, 37, 1000, 1090), (0, 40, 0, 1100)]),
    "haar_int": ((3, 80, 100), 3, "haar_int", [(17, 53, 33, 97), (5, 6, 7, 8)]),
    "haar": ((3, 80, 100), 3, "haar", [(17, 53, 33, 97), (5, 6, 7, 8)]),
}


@pytest.mark.parametrize("case", REGIONS)
def test_decode_region_matches_jax(case):
    shape, levels, wavelet, windows = REGIONS[case]
    x = _u8(shape, seed=21 + levels)
    if wavelet == "haar":
        ts = tpipe.encode(x, levels=levels, device="cpu")
        js = jpipe.encode(x, levels=levels)
    else:
        ts, js = _encode_both(x, levels, wavelet)
    full = tpipe.decode(ts)
    for r0, r1, c0, c1 in windows:
        for emit_u8 in (False, True):
            got = tpipe.decode_region(ts, r0, r1, c0, c1, emit_u8=emit_u8)
            _equal(got, jpipe.decode_region(js, r0, r1, c0, c1, emit_u8=emit_u8))
        assert torch.equal(tpipe.decode_region(ts, r0, r1, c0, c1), full[..., r0:r1, c0:c1])
    with pytest.raises(ValueError):
        tpipe.decode_region(ts, 0, shape[-2] + 1, 0, 4)


def test_region_plan_matches_jax():
    ts, js = _encode_both(_u8((1, 1100, 96), seed=26), 5, "legall5.3")
    for window in ((520, 700, 10, 90), (0, 40, 0, 96), (1050, 1100, 30, 60)):
        assert tpipe.region_plan(ts, *window) == jpipe.region_plan(js, *window)
        assert tpipe.region_coefficient_fraction(ts, *window) == jpipe.region_coefficient_fraction(js, *window)


def test_global_layout_stream_matches_jax():
    """A whole-image (global layout) 5/3 stream decodes through the integer
    lifting inverse, not the tiled kernels."""
    x = _u8((2, 60, 84), seed=27)
    pyr = jax_dwt2_lifting(x, 3, "legall5.3")
    details = tuple(tuple(np.asarray(b).astype(np.int16) for b in bands) for bands in pyr.details)
    meta = dict(spec=JaxQuantSpec(), levels=3, orig_shape=(60, 84), wavelet="legall5.3", layout="global")
    js = jpipe.CodeStream(ll=pyr.ll, details=details, **meta)
    ts = stream_from_arrays(np.asarray(pyr.ll), details, device="cpu", **meta)
    for emit_u8 in (False, True):
        got = tpipe.decode(ts, emit_u8=emit_u8)
        _equal(got, jpipe.decode(js, emit_u8=emit_u8))
    np.testing.assert_array_equal(tpipe.decode(ts).numpy(), x)
    _equal(tpipe.decode_at_level(ts, 2), jpipe.decode_at_level(js, 2))
    _equal(tpipe.decode_region(ts, 10, 30, 20, 50), jpipe.decode_region(js, 10, 30, 20, 50))


@pytest.mark.parametrize("wavelet,color", [("legall5.3", "rct"), ("haar_int", "none")])
def test_cross_decode_lossless_through_interop(wavelet, color):
    x = _u8((3, 50, 61), seed=28)
    ts, js = _encode_both(x, 4, wavelet, color)
    # JAX-encoded stream decoded by the port
    meta = {f.name: getattr(js, f.name) for f in dataclasses.fields(js) if f.name not in ("ll", "details")}
    port_from_jax = stream_from_arrays(np.asarray(js.ll), [[np.asarray(b) for b in bands] for bands in js.details],
                                       device="cpu", **meta)
    assert port_from_jax.ll.dtype == torch.int32 and port_from_jax.details[0][0].dtype == torch.int16
    assert port_from_jax.layout == js.layout == "tiled"
    np.testing.assert_array_equal(tpipe.decode(port_from_jax, emit_u8=True).numpy(), x)
    # port-encoded stream decoded by JAX
    ll, details, meta = stream_to_arrays(ts)
    jax_from_port = _jax_stream(ll, details, meta)
    _assert_streams_equal(ts, jax_from_port)
    np.testing.assert_array_equal(np.asarray(jpipe.decode(jax_from_port, emit_u8=True)), x)


@pytest.mark.parametrize("wavelet", ["haar_int", "legall5.3", "db2", "bior4.4"])
def test_lifting_coder_matches_jax(wavelet):
    img = _u8((45, 70, 3), seed=29)
    got = LiftingCoder(wavelet).get_small_copy(img, 3, border_type=4, device="cpu")
    want = JaxLiftingCoder(wavelet).get_small_copy(img, 3, border_type=4)
    assert got.dtype == want.dtype and got.shape == want.shape
    if wavelet in ("haar_int", "legall5.3"):
        np.testing.assert_array_equal(got, want)
    else:
        # float lifting: the LLs agree to 1e-4 (test_torch_lifting.py), so
        # the truncation to uint8 may differ by one level at a boundary
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    t = LiftingCoder(wavelet).get_small_copy(torch.from_numpy(img), 3, border_type=4)
    assert isinstance(t, torch.Tensor) and np.array_equal(t.numpy(), got)
    with pytest.raises(ValueError):
        LiftingCoder("nope")


def test_lossless_option_errors():
    x = _u8((3, 32, 32))
    for kw in (dict(color="rct"), dict(wavelet="legall5.3", color="ict"), dict(wavelet="nope")):
        with pytest.raises(ValueError):
            tpipe.encode(x, levels=2, device="cpu", **kw)
    with pytest.raises(ValueError):
        tpipe.encode(_u8((32, 32)), levels=2, wavelet="legall5.3", color="rct", device="cpu")
