"""The port's rate control (``wicca_tpu_torch.codec.rd``) and SSIM/MS-SSIM
(``wicca_tpu_torch.core.metrics``) against ``wicca_tpu`` on the CPU.

Held exactly: the step searches (``encode_to_bpp``, ``encode_to_psnr``:
chosen step, probe count, rate and stream), the synthesis gains of
``haar`` and the integer wavelets, the PCRD tables (``measure``), the
divisors (``allocate``, ``truncate``) and the truncated stream's container
bytes, for ``haar`` and ``legall5.3``. Within a stated tolerance: the float
wavelets' synthesis gains (relative 1e-5: both sum float32 impulse
responses, and the reference's XLA build may contract products into
FMAs), the reported PSNR (1e-3 dB, the value's own rounding), and
``ssim``/``ms_ssim`` (absolute 1e-5: float32 window sums in another
order). The reference's searches run its Pallas encoder in interpret mode
at one 64 x 96 shape."""

import dataclasses

import numpy as np
import pytest
import torch

from tests.test_torch_codec import _assert_streams_equal
from tests.test_torch_codec_streams import _jax_stream
from tests.test_torch_dwt97 import one_torch_thread  # noqa: F401 (fixture)
from wicca_tpu.codec import container as jcont
from wicca_tpu.codec import rd as jrd
from wicca_tpu.core import metrics as jmetrics
from wicca_tpu_torch.codec import container as tcont
from wicca_tpu_torch.codec import pipeline as tpipe
from wicca_tpu_torch.codec import rd as trd
from wicca_tpu_torch.codec.interop import stream_to_arrays
from wicca_tpu_torch.core import metrics as tmetrics
from wicca_tpu_torch.core.quant import QuantSpec


def _photo(shape, seed):
    rng = np.random.default_rng(seed)
    c, h, w = shape
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = 128 + 55 * np.sin(xx / 11 + seed) * np.cos(yy / 13) + 30 * np.sin((xx + yy) / 5)
    return np.clip(base + rng.normal(0, 6, shape), 0, 255).astype(np.uint8)


X = _photo((1, 64, 96), seed=1)


@pytest.mark.parametrize("rate, target", [("entropy", 2.5), ("actual", 3.0)])
def test_encode_to_bpp_matches_the_reference(rate, target):
    ts, tinfo = trd.encode_to_bpp(X, target, levels=3, rate=rate, codec="rice", device="cpu")
    js, jinfo = jrd.encode_to_bpp(X, target, levels=3, rate=rate, codec="rice")
    assert tinfo == jinfo and tinfo["met"]
    _assert_streams_equal(ts, js)


def test_encode_to_psnr_matches_the_reference():
    ts, tinfo = trd.encode_to_psnr(X, 38.0, levels=3, device="cpu")
    js, jinfo = jrd.encode_to_psnr(X, 38.0, levels=3)
    assert {k: v for k, v in tinfo.items() if k != "psnr_db"} == {k: v for k, v in jinfo.items() if k != "psnr_db"}
    assert tinfo["psnr_db"] == pytest.approx(jinfo["psnr_db"], abs=1e-3) and tinfo["met"]
    _assert_streams_equal(ts, js)


def test_lossless_wavelets_are_not_rate_controllable():
    for fn in (lambda: trd.encode_to_bpp(X, 1.0, wavelet="legall5.3", device="cpu"),
               lambda: trd.encode_to_psnr(X, 30.0, wavelet="haar_int", device="cpu")):
        with pytest.raises(ValueError, match="lossless"):
            fn()


@pytest.mark.parametrize("wavelet", ["haar", "haar_int", "legall5.3", "bior4.4", "cdf97", "db2"])
def test_synthesis_gains(wavelet):
    got, want = trd.synthesis_gains(wavelet, 3), jrd.synthesis_gains(wavelet, 3)
    if wavelet in ("haar", "haar_int", "legall5.3"):
        assert got == want
    else:
        np.testing.assert_allclose(np.array(got), np.array(want), rtol=1e-5, atol=0)


@pytest.mark.parametrize("wavelet, color", [("haar", "none"), ("legall5.3", "rct")])
def test_pcrd_tables_divisors_and_bytes_match_the_reference(wavelet, color):
    x = _photo((3, 64, 96), seed=4)
    spec = QuantSpec(base_step=0.5)
    ts = tpipe.encode(x, levels=3, spec=spec, wavelet=wavelet, color=color, device="cpu")
    js = _jax_stream(*stream_to_arrays(ts))
    tables = trd.measure(ts)
    assert [dataclasses.astuple(t) for t in tables] == [dataclasses.astuple(t) for t in jrd.measure(js)]
    full = sum(t.rates[0] for t in tables)
    for frac in (0.6, 0.3):
        assert trd.allocate(tables, int(full * frac)) == jrd.allocate(tables, int(full * frac))
    # the port counts the WCT9 header exactly; the reference adds levels*3
    # bytes to the WCT4 header, short by the extended block (4 + 4 bytes)
    # and the empty metadata count (2): with that made good, the same result
    n = 3 * ts.levels
    short = len(jcont.serialize(dataclasses.replace(js, band_div=(2,) * n))) - len(jcont.serialize(js)) - n
    assert short == 10
    budget = int(0.4 * len(tcont.serialize(ts)))
    small, jsmall = trd.truncate(ts, target_bytes=budget), jrd.truncate(js, target_bytes=budget - short)
    assert small.band_div == tuple(jsmall.band_div) and any(d > 1 for d in small.band_div)
    _assert_streams_equal(small, jsmall)
    blob = tcont.serialize(small)
    assert blob == jcont.serialize(jsmall) and blob[:4] == b"WCT9" and len(blob) <= budget
    back = tcont.deserialize(blob, device="cpu")
    assert back.band_div == small.band_div
    assert torch.equal(tpipe.decode(back, emit_u8=True), tpipe.decode(small, emit_u8=True))
    with pytest.raises(ValueError, match="already"):
        trd.measure(small)


def test_truncate_target_bpp_and_refusals():
    ts = tpipe.encode(X, levels=3, spec=QuantSpec(base_step=0.5), device="cpu")
    small = trd.truncate(ts, target_bpp=1.5, codec="rice")
    h, w = ts.orig_shape
    assert len(tcont.serialize(small, codec="rice")) <= 1.5 * h * w / 8
    with pytest.raises(ValueError, match="exactly one"):
        trd.truncate(ts)
    with pytest.raises(ValueError, match="ROI"):
        trd.measure(dataclasses.replace(ts, roi_shift=2))


def test_rd_point_curve_and_plot():
    pts = trd.rd_curve(X, steps=(1.0, 4.0), levels=3, actual_bytes=True, device="cpu")
    assert [p["step"] for p in pts] == [1.0, 4.0]
    assert pts[0]["psnr_db"] > pts[1]["psnr_db"] and pts[0]["bpp_actual"] > pts[1]["bpp_actual"]
    assert 0 < pts[1]["ssim"] <= pts[0]["ssim"] <= 1 and 0 < pts[1]["ms_ssim"] <= 1
    fig = trd.plot_rd_curve(pts)
    assert fig.axes[0].get_xlabel() == "bits per pixel"


def _pair(shape, seed, noise):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, shape).astype(np.float32)
    return a, np.clip(a + rng.normal(0, noise, shape), 0, 255).astype(np.float32)


@pytest.mark.parametrize("shape, noise, window", [
    ((64, 96), 5.0, 8), ((3, 61, 83), 20.0, 8), ((2, 1, 40, 40), 60.0, 4), ((130, 150), 2.0, 8), ((20, 30), 10.0, 8),
])
def test_ssim_and_ms_ssim_match_the_reference(shape, noise, window):
    a, b = _pair(shape, seed=len(shape), noise=noise)
    for t_fn, j_fn in ((tmetrics.ssim, jmetrics.ssim), (tmetrics.ms_ssim, jmetrics.ms_ssim)):
        got = t_fn(torch.from_numpy(a), torch.from_numpy(b), window=window)
        assert got.dtype == torch.float32
        assert float(got) == pytest.approx(float(j_fn(a, b, window=window)), abs=1e-5)
    assert float(tmetrics.ssim(torch.from_numpy(a), torch.from_numpy(a))) == pytest.approx(1.0, abs=1e-6)
