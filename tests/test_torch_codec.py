"""The port's Haar codec against ``wicca_tpu.codec.pipeline`` on the CPU:
LL, every code plane (values and dtype), stored shapes, float32 and uint8
reconstructions, over depths 1-6 and the quantizer settings, plus the
stream helpers and the options the earlier slices left out. Float input, tile padding, R-D divisors and streams decoded
across the two packages are in ``test_torch_codec_streams.py``. Tolerance 0
throughout."""

import dataclasses

import numpy as np
import pytest
import torch

from wicca_tpu.codec import pipeline as jpipe
from wicca_tpu.core.quant import QuantSpec as JaxQuantSpec
from wicca_tpu_torch.codec import pipeline as tpipe
from wicca_tpu_torch.core.quant import QuantSpec

SPECS = {
    "step1": dict(base_step=1.0),
    "step0.75-hh1.5": dict(base_step=0.75, hh_gain=1.5),
    "step2.5-lg1.5": dict(base_step=2.5, level_gain=1.5),
}
DECODES = [(False, 0.3), (True, 0.5)]  # (emit_u8, recon_offset)


def _u8(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, size=shape, dtype=np.uint8)


def _assert_streams_equal(ts, js):
    assert ts.levels == js.levels and ts.orig_shape == tuple(js.orig_shape)
    ll = np.asarray(js.ll)
    assert ts.ll.numpy().dtype == ll.dtype
    np.testing.assert_array_equal(ts.ll.numpy(), ll)
    assert len(ts.details) == len(js.details)
    for tb, jb in zip(ts.details, js.details):
        for t, j in zip(tb, jb):
            j = np.asarray(j)
            assert t.numpy().dtype == j.dtype and t.shape == j.shape
            np.testing.assert_array_equal(t.numpy(), j)


def _assert_decodes_equal(ts, js, decodes=DECODES):
    for emit_u8, off in decodes:
        got = tpipe.decode(ts, emit_u8=emit_u8, recon_offset=off).numpy()
        want = np.asarray(jpipe.decode(js, emit_u8=emit_u8, recon_offset=off))
        assert got.dtype == want.dtype and got.shape == want.shape, (emit_u8, off)
        np.testing.assert_array_equal(got, want)


def _encode_both(x, levels, spec_kw, **kw):
    ts = tpipe.encode(x, levels=levels, spec=QuantSpec(**spec_kw), device="cpu", **kw)
    js = jpipe.encode(x, levels=levels, spec=JaxQuantSpec(**spec_kw), **kw)
    return ts, js


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("levels", [1, 2, 3, 4, 5, 6])
def test_encode_decode_u8_matches_jax(levels, spec):
    # 45 x 70 is divisible by 2**levels for no level here
    ts, js = _encode_both(_u8((3, 45, 70), seed=levels), levels, SPECS[spec])
    _assert_streams_equal(ts, js)
    _assert_decodes_equal(ts, js)


@pytest.mark.parametrize("mode", ["constant", "reflect", "wrap"])
def test_encode_border_modes_batched(mode):
    ts, js = _encode_both(_u8((2, 2, 21, 30), seed=8), 3, SPECS["step0.75-hh1.5"], mode=mode, constant=40)
    _assert_streams_equal(ts, js)
    _assert_decodes_equal(ts, js, [(True, 0.5)])


def test_stream_helpers_match_jax():
    yy, xx = np.mgrid[0:96, 0:128].astype(np.float32)
    smooth = np.clip(128 + 60 * np.sin(xx / 19) + 50 * np.cos(yy / 23), 0, 255).astype(np.uint8)
    ts, js = _encode_both(np.stack([smooth, smooth[::-1]]), 4, dict(base_step=4.0))
    icon = tpipe.icon_from_stream(ts)
    assert icon.dtype == torch.uint8 and tuple(icon.shape) == (2, 6, 8)
    np.testing.assert_array_equal(icon.numpy(), np.asarray(jpipe.icon_from_stream(js)))
    assert ts.num_bytes() == js.num_bytes()
    assert tpipe.compression_ratio(ts) == jpipe.compression_ratio(js)
    assert tpipe.estimated_entropy_bytes(ts) == jpipe.estimated_entropy_bytes(js)
    assert tpipe.entropy_ratio(ts) == jpipe.entropy_ratio(js) > 3.0


def test_psnr_of_roundtrip():
    from wicca_tpu_torch.core.metrics import psnr

    x = torch.from_numpy(_u8((3, 128, 128), seed=12))
    rec = tpipe.decode(tpipe.encode(x, levels=5, spec=QuantSpec(1.0)), emit_u8=True)
    assert rec.dtype == torch.uint8 and rec.shape == x.shape
    assert float(psnr(rec, x)) > 30.0


@pytest.mark.parametrize("kw", [
    dict(wavelet="cdf97"), dict(wavelet="db2"), dict(color="ict"), dict(bit_depth=12, wavelet="legall5.3"),
])
def test_unported_options_raise(kw):
    """These options raised until the float codec (K8/K9, ICT) and the
    9-16-bit path were ported; now each encodes and decodes: stream fields,
    stored shapes and dtypes as JAX's; the lossy reconstructions within 40
    grey levels of the input, the lossless 12-bit one exact (the float
    codec's tolerance against JAX: test_torch_codec_float.py)."""
    x = _u8((3, 16, 16), seed=13)
    ts = tpipe.encode(torch.from_numpy(x), levels=2, **kw)
    js = jpipe.encode(x, levels=2, **kw)
    assert (ts.wavelet, ts.color, ts.layout, ts.bit_depth) == (js.wavelet, js.color, js.layout, js.bit_depth)
    for t, j in zip([ts.ll] + [b for bands in ts.details for b in bands],
                    [js.ll] + [b for bands in js.details for b in bands]):
        assert t.numpy().dtype == np.asarray(j).dtype and t.shape == j.shape
    got, want = tpipe.decode(ts, emit_u8=True).numpy(), np.asarray(jpipe.decode(js, emit_u8=True))
    assert got.dtype == want.dtype and got.shape == want.shape == x.shape
    assert np.abs(got.astype(int) - x.astype(int)).max() <= (0 if "bit_depth" in kw else 40)


def test_unported_streams_raise():
    """Haar has no 9-16-bit path in either package, and an unknown color
    raises. ROI streams raised here until ROI coding was ported; now an
    ROI-scaled stream of zero codes decodes as the stream itself
    (test_torch_roi.py holds ROI against wicca_tpu)."""
    with pytest.raises(ValueError, match="lifting wavelet"):
        tpipe.encode(torch.zeros((1, 16, 16), dtype=torch.uint16), levels=2)
    ts = tpipe.encode(torch.zeros((1, 16, 16), dtype=torch.uint8), levels=2)
    want = tpipe.decode(ts, emit_u8=True)
    for change in (dict(roi_shift=3), dict(roi_shift=2, bg_shift=2), dict(roi_shift=1, bg_shift=6)):
        assert torch.equal(tpipe.decode(dataclasses.replace(ts, **change), emit_u8=True), want)
    with pytest.raises(ValueError):
        tpipe.encode(torch.zeros((1, 16, 16), dtype=torch.uint8), levels=2, color="yuv")
