"""The port's maxshift ROI coding (``wicca_tpu_torch.codec.roi``) and the
decoders' ROI normalization against ``wicca_tpu`` on the CPU.

Streams are encoded by the port (``device='cpu'``) and carried to the JAX
package with ``codec/interop.py``; ``apply_roi`` runs in both packages on
the same codes. Held exactly: ``band_mask`` at odd and tile-padded band
shapes, the ROI codes, their dtype and ``roi_shift`` (masks crossing the
(512, 1024) tile seams, ``bg_shift`` 0 and 2), the normalized codes, the
WCT6 bytes and their layered truncation, and the decodes of ``haar`` and
``legall5.3``; ``cdf97`` decodes within the float tolerance of
``tests/test_torch_dwt97.py``. Four JAX decodes run Pallas in interpret
mode, each at one small shape."""

import dataclasses

import numpy as np
import pytest
import torch

from tests.test_torch_codec import _assert_streams_equal
from tests.test_torch_codec_streams import _jax_stream
from tests.test_torch_dwt97 import assert_close, one_torch_thread  # noqa: F401 (fixture)
from wicca_tpu.codec import container as jcont
from wicca_tpu.codec import pipeline as jpipe
from wicca_tpu.codec import roi as jroi
from wicca_tpu_torch.codec import container as tcont
from wicca_tpu_torch.codec import pipeline as tpipe
from wicca_tpu_torch.codec import roi as troi
from wicca_tpu_torch.codec.interop import stream_from_arrays, stream_to_arrays
from wicca_tpu_torch.core.quant import QuantSpec


def _img(shape, seed):
    """Smooth content plus noise, so that ROI and background codes differ."""
    rng = np.random.default_rng(seed)
    c, h, w = shape
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = 128 + 60 * np.sin(xx / 9 + seed) + 50 * np.cos(yy / 7)
    return np.clip(base + rng.normal(0, 12, shape), 0, 255).astype(np.uint8)


def _mask(h, w, r0, r1, c0, c1):
    m = np.zeros((h, w), bool)
    m[r0:r1, c0:c1] = True
    return m


def _both(x, wavelet, **kw):
    ts = tpipe.encode(x, levels=3, spec=QuantSpec(base_step=1.0), wavelet=wavelet, device="cpu", **kw)
    return ts, _jax_stream(*stream_to_arrays(ts))


def _port_of(js):
    """A JAX stream carried to the port (numpy bands and meta fields)."""
    meta = {f.name: getattr(js, f.name) for f in dataclasses.fields(js) if f.name not in ("ll", "details")}
    return stream_from_arrays(np.asarray(js.ll), [[np.asarray(b) for b in bands] for bands in js.details],
                              device="cpu", **meta)


def _assert_roi_equal(ts, js):
    _assert_streams_equal(ts, js)
    assert (ts.roi_shift, ts.bg_shift) == (js.roi_shift, js.bg_shift)


@pytest.mark.parametrize("shape, level, margin, band", [
    ((61, 83), 1, 0, (31, 42)), ((61, 83), 3, 2, (8, 11)), ((61, 83), 2, 4, (16, 21)),
    ((1100, 96), 1, 2, (768, 48)), ((1100, 96), 3, 4, (192, 12)), ((72, 1100), 2, 2, (18, 512)),
    ((64, 64), 2, 1, (20, 20)),
])
def test_band_mask_matches_the_reference(shape, level, margin, band):
    rng = np.random.default_rng(level * 10 + margin)
    for m in (rng.random(shape) < 0.01, _mask(*shape, 5, shape[0] // 2, 7, shape[1] - 3)):
        got = troi.band_mask(m, *band, level, margin)
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), jroi.band_mask(m, *band, level, margin))


# the 1100-row frame crosses the 512-row tile seam; the mask crosses it too
SEAM = dict(shape=(1, 1100, 96), mask=(400, 700, 10, 60))


@pytest.mark.parametrize("bg_shift", [0, 2])
@pytest.mark.parametrize("wavelet", ["haar", "legall5.3", "cdf97"])
def test_apply_roi_and_normalization_match_the_reference(wavelet, bg_shift):
    x = _img(SEAM["shape"], seed=bg_shift)
    ts, js = _both(x, wavelet)
    mask = _mask(*SEAM["shape"][1:], *SEAM["mask"])
    tr, jr = troi.apply_roi(ts, mask, bg_shift=bg_shift), jroi.apply_roi(js, mask, bg_shift=bg_shift)
    assert tr.roi_shift >= 1
    _assert_roi_equal(tr, jr)
    _assert_streams_equal(tpipe._normalize_roi(tr), jpipe._normalize_roi(jr))
    # a tensor mask gives the same stream; the stream's own codes never change
    _assert_roi_equal(troi.apply_roi(ts, torch.from_numpy(mask), bg_shift=bg_shift), jr)
    _assert_streams_equal(ts, js)
    # the region decodes as the stream without ROI
    r0, r1, c0, c1 = SEAM["mask"]
    want = tpipe.decode(ts, emit_u8=True)[..., r0:r1, c0:c1]
    assert torch.equal(tpipe.decode(tr, emit_u8=True)[..., r0:r1, c0:c1], want)
    assert torch.equal(tpipe.decode_region(tr, r0, r1, c0, c1, emit_u8=True), want)


@pytest.mark.parametrize("wavelet", ["haar", "legall5.3", "cdf97"])
def test_roi_decode_matches_the_reference(wavelet):
    x = _img((3, 64, 96), seed=7)
    ts, js = _both(x, wavelet)
    mask = _mask(64, 96, 8, 40, 30, 90)
    tr, jr = troi.apply_roi(ts, mask, bg_shift=2), jroi.apply_roi(js, mask, bg_shift=2)
    got, want = tpipe.decode(tr), jpipe.decode(jr)
    if wavelet == "cdf97":
        assert_close(got, want, "cdf97 ROI decode")
    else:
        assert got.numpy().dtype == np.asarray(want).dtype
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_icon_and_decode_at_level_of_a_reference_roi_stream():
    """The fault these repair: a stream ROI-coded by the reference and
    carried across; the port's icon_from_stream and decode_at_level raised
    NotImplementedError and now give the reference's results."""
    x = _img((3, 64, 96), seed=11)
    ts, js = _both(x, "legall5.3", color="rct")
    jr = jroi.apply_roi(js, _mask(64, 96, 10, 50, 20, 70), bg_shift=2)
    tr = _port_of(jr)
    assert tr.roi_shift == jr.roi_shift > 0
    np.testing.assert_array_equal(tpipe.icon_from_stream(tr).numpy(), np.asarray(jpipe.icon_from_stream(jr)))
    assert torch.equal(tpipe.icon_from_stream(tr), tpipe.icon_from_stream(ts))
    got, want = tpipe.decode_at_level(tr, 2), jpipe.decode_at_level(jr, 2)
    assert got.numpy().dtype == np.asarray(want).dtype
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("wavelet", ["haar", "legall5.3"])
def test_roi_container_bytes_and_layered_truncation(wavelet):
    x = _img((1, 64, 64), seed=3)
    ts, js = _both(x, wavelet)
    mask = _mask(64, 64, 16, 48, 16, 48)
    tr, jr = troi.apply_roi(ts, mask, bg_shift=0), jroi.apply_roi(js, mask, bg_shift=0)
    for layers in (1, 3):
        blob = tcont.serialize(tr, quality_layers=layers)
        assert blob[:4] == b"WCT6" and blob == jcont.serialize(jr, quality_layers=layers)
        for keep in range(1, layers + 1):
            if layers - keep >= tr.roi_shift:
                with pytest.raises(ValueError, match="guard bits"):
                    tcont.deserialize(blob, max_layers=keep, device="cpu")
                continue
            back = tcont.deserialize(blob, max_layers=keep, device="cpu")
            _assert_roi_equal(back, jcont.deserialize(blob, max_layers=keep))
            # truncation burns guard bits inside the region, which stays exact
            assert torch.equal(tpipe.decode(back)[..., 16:48, 16:48], tpipe.decode(ts)[..., 16:48, 16:48])


def test_roi_refusals():
    ts, _ = _both(_img((1, 64, 64), seed=1), "haar")
    with pytest.raises(ValueError, match="mask shape"):
        troi.apply_roi(ts, np.zeros((32, 32), bool))
    with pytest.raises(ValueError, match="empty"):
        troi.apply_roi(ts, np.zeros((64, 64), bool))
    roi = troi.apply_roi(ts, _mask(64, 64, 0, 8, 0, 8))
    with pytest.raises(ValueError, match="already"):
        troi.apply_roi(roi, _mask(64, 64, 0, 8, 0, 8))
    with pytest.raises(ValueError, match="bg_shift"):
        troi.apply_roi(ts, _mask(64, 64, 0, 8, 0, 8), bg_shift=9)
