"""The port's host routes (``wicca_tpu_torch.codec.host_encode`` and
``host_decode``, C++ in ``wicca_tpu_torch/native/idwt.cpp``) against the
reference's host routes (``wicca_tpu.codec.host_encode``/``host_decode``)
and against the port's own device route (``encode``/``decode`` with
``device='cpu'``, the kernels' plain twins), on the native and the numpy
paths (``WICCA_TPU_NO_NATIVE_IDWT``, read by both packages).

Tolerance 0 everywhere, except ``ict`` against the device route: within 1
gray level, as the reference states. Streams cross between the packages
through ``codec/interop.py``; the reference's Pallas decode runs (in
interpret mode) only for the non-power-of-two step cases."""

import dataclasses

import numpy as np
import pytest
import torch

from tests.test_host_decode import photo
from tests.test_torch_codec_streams import _jax_stream
from tests.test_torch_dwt97 import one_torch_thread  # noqa: F401 (fixture)
from wicca_tpu.codec import container as jcont
from wicca_tpu.codec import host_decode as jhd
from wicca_tpu.codec import host_encode as jhe
from wicca_tpu.codec import pipeline as jpipe
from wicca_tpu.core.quant import QuantSpec as JaxQuantSpec
from wicca_tpu_torch.codec import container as tcont
from wicca_tpu_torch.codec import host_decode as thd
from wicca_tpu_torch.codec import host_encode as the
from wicca_tpu_torch.codec import pipeline as tpipe
from wicca_tpu_torch.codec.interop import stream_to_arrays
from wicca_tpu_torch.core.lifting import is_integer_wavelet
from wicca_tpu_torch.core.quant import QuantSpec


@pytest.fixture(params=["native", "numpy"])
def route(request, monkeypatch):
    """The native C++ levels or the numpy mirrors, in both packages."""
    if request.param == "numpy":
        monkeypatch.setenv("WICCA_TPU_NO_NATIVE_IDWT", "1")
    return request.param


def _jax_of(ts):
    return _jax_stream(*stream_to_arrays(ts))


def _assert_planes_equal(ts, other):
    """Port stream ``ts`` equals ``other`` (port or JAX) plane for plane."""
    assert np.array_equal(ts.ll.numpy(), np.asarray(other.ll))
    assert len(ts.details) == len(other.details)
    for tb, ob in zip(ts.details, other.details):
        for a, b in zip(tb, ob):
            b = np.asarray(b.numpy() if isinstance(b, torch.Tensor) else b)
            assert a.numpy().dtype == b.dtype and a.numpy().shape == b.shape
            np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize("step", [1.0, 0.5, 4.0])
@pytest.mark.parametrize("shape", [(256, 320), (250, 318)])
@pytest.mark.parametrize("levels", [1, 3, 5])
def test_host_encode_matches_the_reference_and_the_device_route(levels, shape, step, route):
    x = photo(*shape, seed=levels)
    ts = the.host_encode(x, levels=levels, spec=QuantSpec(base_step=step))
    js = jhe.host_encode(x, levels=levels, spec=JaxQuantSpec(base_step=step))
    _assert_planes_equal(ts, js)
    assert ts.ll.device.type == "cpu"
    _assert_planes_equal(ts, tpipe.encode(x, levels=levels, spec=QuantSpec(base_step=step), device="cpu"))
    if levels == 3:  # the same .wct bytes (the planes already are equal)
        assert tcont.serialize(ts) == jcont.serialize(js)


@pytest.mark.parametrize("mode,constant", [("replicate", 0), ("constant", 7), ("reflect", 0)])
def test_host_encode_pad_modes_and_hh_gain(mode, constant):
    x = photo(100, 130, seed=10)
    spec = QuantSpec(base_step=1.0, hh_gain=2.0)
    ts = the.host_encode(x, levels=3, spec=spec, mode=mode, constant=constant)
    _assert_planes_equal(ts, tpipe.encode(x, levels=3, spec=spec, mode=mode, constant=constant, device="cpu"))
    _assert_planes_equal(ts, jhe.host_encode(x, levels=3, spec=JaxQuantSpec(base_step=1.0, hh_gain=2.0),
                                             mode=mode, constant=constant))
    assert torch.equal(the.host_encode(torch.from_numpy(x), levels=3, spec=spec, mode=mode, constant=constant).ll,
                       ts.ll)


def test_host_encode_gate_and_refusals():
    x = photo(64, 64, seed=12)
    assert the.supported_encode(x, "haar", "none", 8)
    assert the.supported_encode(torch.from_numpy(x), "haar", "none", None)
    for args in (("haar", "ict", 8), ("bior4.4", "none", 8), ("haar", "none", 12)):
        assert not the.supported_encode(x, *args)
        assert not jhe.supported_encode(x, *args)
    assert not the.supported_encode(x, "haar", "none", 8, keep_alpha=True)
    assert not the.supported_encode(x.astype(np.float32), "haar", "none", 8)
    with pytest.raises(TypeError):
        the.host_encode(x.astype(np.float32))
    assert the.measured_mp_per_s() > 0


# case -> (image (h, w, channels, seed), encode options, stream changes)
DECODE_CASES = {
    "haar-offset0.5": ((192, 256, 3, 11), dict(spec=dict(base_step=2.0), levels=4), {}),
    "haar-gray-odd": ((250, 318, 1, 19), dict(spec=dict(base_step=1.0), levels=5), {}),
    "haar-banddiv": ((96, 128, 3, 12), dict(spec=dict(base_step=0.5), levels=3),
                     dict(band_div=(2, 3, 1, 1, 1, 4, 1, 2, 1))),
    "haar-step0.75-hh1.5": ((96, 128, 3, 13), dict(spec=dict(base_step=0.75, hh_gain=1.5), levels=3), {}),
    "haar_int": ((250, 322, 3, 13), dict(wavelet="haar_int", levels=4), {}),
    "haar_int-banddiv": ((96, 128, 3, 14), dict(wavelet="haar_int", levels=3),
                         dict(band_div=(1, 2, 3, 1, 1, 2, 1, 1, 1))),
    "haar_int-rct-rgba": ((128, 160, 4, 20), dict(wavelet="haar_int", color="rct", levels=2), {}),
    "legall5.3-rct": ((192, 224, 3, 15), dict(wavelet="legall5.3", color="rct", levels=5), {}),
    "legall5.3-tiles": ((520, 1040, 1, 18), dict(wavelet="legall5.3", levels=5), {}),
    "legall5.3-banddiv": ((96, 128, 3, 16), dict(wavelet="legall5.3", levels=3), dict(band_div=(2,) * 9)),
    "legall5.3-12bit-global": (None, dict(wavelet="legall5.3", bit_depth=12, levels=3), {}),
}


def _decode_case(case):
    img, enc, changes = DECODE_CASES[case]
    enc = dict(enc)
    spec = QuantSpec(**enc.pop("spec", {}))
    if img is None:
        x = (np.random.default_rng(17).integers(0, 4096, (1, 160, 192)) & 0xFFF).astype(np.uint16)
    else:
        h, w, c, seed = img
        x = photo(h, w, seed=seed, channels=c)
    return dataclasses.replace(tpipe.encode(x, spec=spec, device="cpu", **enc), **changes), x


@pytest.mark.parametrize("case", DECODE_CASES)
def test_host_decode_matches_the_reference_and_the_device_route(case, route):
    ts, x = _decode_case(case)
    js = _jax_of(ts)
    assert thd.supported(ts) and jhd.supported(js)
    assert thd.agrees_with_device(ts)
    for tl in sorted({0, 2, ts.levels}):
        got = thd.host_decode(ts, target_level=tl)
        assert got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), jhd.host_decode(js, target_level=tl))
        want = tpipe.decode_at_level(ts, tl, emit_u8=True)
        assert got.dtype == want.dtype and torch.equal(got, want), tl
    if is_integer_wavelet(ts.wavelet) and not ts.band_div:
        np.testing.assert_array_equal(thd.host_decode(ts).numpy(), x)  # lossless
    f32 = thd.host_decode(ts, emit_u8=False, recon_offset=0.3)
    np.testing.assert_array_equal(f32.numpy(), jhd.host_decode(js, emit_u8=False, recon_offset=0.3))


def test_ict_host_decode_within_one_gray_level(route):
    x = photo(192, 224, seed=16)
    ts = tpipe.encode(x, levels=3, spec=QuantSpec(base_step=1.0), color="ict", chroma_gain=2.0, device="cpu")
    got = thd.host_decode(ts)
    np.testing.assert_array_equal(got.numpy(), jhd.host_decode(_jax_of(ts)))  # the reference's host route exactly
    diff = (got.to(torch.int16) - tpipe.decode(ts, emit_u8=True).to(torch.int16)).abs()
    assert int(diff.max()) <= 1 and float((diff > 0).float().mean()) < 1e-3
    assert thd.supported(ts) and not thd.agrees_with_device(ts)


# (base step, hh gain, recon offset, whether the LH/HL dequantization products are exact)
STEPS = {
    "step0.1": (0.1, 1.0, 0.5, False),
    "step0.75-offset0.3": (0.75, 1.0, 0.3, False),
    "step0.75-hh1.5": (0.75, 1.5, 0.5, True),
}


@pytest.mark.parametrize("case", STEPS)
def test_host_and_device_routes_at_non_power_of_two_steps(case):
    """The port's host route equals the reference's host route and its
    device route the reference's device route (Pallas, interpret mode), at
    any step. The two routes differ from each other where the LH/HL
    dequantization products round (the device fuses them into fused
    multiply-adds), in the reference and in the port alike;
    ``agrees_with_device`` says so beforehand."""
    step, hh, offset, exact = STEPS[case]
    x = photo(64, 96, seed=3)
    ts = the.host_encode(x, levels=3, spec=QuantSpec(base_step=step, hh_gain=hh))
    js = jhe.host_encode(x, levels=3, spec=JaxQuantSpec(base_step=step, hh_gain=hh))
    host = thd.host_decode(ts, emit_u8=False, recon_offset=offset).numpy()
    np.testing.assert_array_equal(host, jhd.host_decode(js, emit_u8=False, recon_offset=offset))
    device = tpipe.decode(ts, recon_offset=offset).numpy()
    np.testing.assert_array_equal(device, np.asarray(jpipe.decode(js, recon_offset=offset)))
    assert thd.agrees_with_device(ts, offset) == exact
    assert np.array_equal(host, device) == exact
    assert np.abs(host - device).max() < 1e-3


def test_unsupported_streams_raise():
    x = photo(64, 64, seed=18)
    for kw in (dict(wavelet="bior4.4"), dict(wavelet="db2", color="ict")):
        ts = tpipe.encode(x, levels=2, device="cpu", **kw)
        assert not thd.supported(ts) and not thd.agrees_with_device(ts)
        with pytest.raises(ValueError):
            thd.host_decode(ts)
    ts = tpipe.encode(x, levels=2, device="cpu")
    with pytest.raises(ValueError):
        thd.host_decode(ts, target_level=3)
    roi = dataclasses.replace(ts, roi_shift=3)
    assert not thd.supported(roi) and not jhd.supported(_jax_of(roi))
    assert thd._rate_kind(ts) == "haar" and thd.measured_mp_per_s("tiled53") > 0
