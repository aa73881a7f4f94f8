"""The port's whole-image (``layout='global'``) lifting paths against
``wicca_tpu.codec.pipeline`` on the CPU: global-layout float streams (with
the halo ``decode_region``), registered wavelets, and the 9-16-bit path
(int32 codes, uint16 output). Integer results bit for bit; float results
within the tolerance of ``tests/test_torch_dwt97.py``, the halo region
against the port's own full decode at ``atol 2e-3`` as the reference's test
holds it (``tests/test_codec.py:520-543``)."""

import numpy as np
import pytest
import torch

from tests.test_torch_codec_float import _assert_cross_decodes, _assert_streams_close, _encode_both, _port_from_jax, _u8
from tests.test_torch_dwt97 import assert_close, flat, one_torch_thread  # noqa: F401 (fixture)
from wicca_tpu.codec import pipeline as jpipe
from wicca_tpu.core.lifting import dwt2_level_lifting as jax_dwt2_level_lifting
from wicca_tpu.core.quant import QuantSpec as JaxQuantSpec
from wicca_tpu.core.quant import quantize_deadzone as jax_quantize_deadzone
from wicca_tpu_torch.codec import pipeline as tpipe
from wicca_tpu_torch.codec.interop import stream_from_arrays


def _global_stream(x, levels, wavelet="bior4.4"):
    """A whole-image (global layout) float stream, built as the reference's
    tests build one (tests/test_codec.py:530-540), in both packages."""
    spec = JaxQuantSpec(base_step=1.0)
    ll, details = x.astype(np.float32), []
    for lvl in range(1, levels + 1):
        ll, lh, hl, hh = jax_dwt2_level_lifting(ll, wavelet)
        details.append(tuple(np.asarray(jax_quantize_deadzone(b, spec.detail_step(lvl), np.int16))
                             for b in (lh, hl, hh)))
    meta = dict(spec=spec, levels=levels, orig_shape=x.shape[-2:], wavelet=wavelet, layout="global")
    js = jpipe.CodeStream(ll=ll, details=tuple(details), **meta)
    return stream_from_arrays(np.asarray(ll), details, device="cpu", **meta), js


def test_global_layout_float_stream_matches_jax():
    x = _u8((1, 96, 160), seed=31)
    ts, js = _global_stream(x, 2)
    for emit_u8 in (False, True):
        assert_close(tpipe.decode(ts, emit_u8=emit_u8), jpipe.decode(js, emit_u8=emit_u8), f"emit_u8={emit_u8}")
    assert_close(tpipe.decode_at_level(ts, 1), jpipe.decode_at_level(js, 1), "decode_at_level 1")
    # the 16 << levels halo covers the inverse cascade
    full = tpipe.decode(ts).numpy()
    roi = tpipe.decode_region(ts, 30, 70, 50, 120)
    np.testing.assert_allclose(roi.numpy(), full[..., 30:70, 50:120], rtol=0, atol=2e-3)
    assert_close(roi, jpipe.decode_region(js, 30, 70, 50, 120), "decode_region")


def test_registered_wavelet_takes_the_global_path():
    """A wavelet outside the fused kernels (here a registered copy of db2 in
    both packages) encodes by whole-image lifting with int16 codes."""
    from wicca_tpu.core import lifting as jlift
    from wicca_tpu_torch.core import lifting as tlift

    jlift.register_wavelet("db2_copy", jlift.db2_fwd1d, jlift.db2_inv1d)
    tlift.register_wavelet("db2_copy", tlift.db2_fwd1d, tlift.db2_inv1d)
    ts, js = _encode_both(_u8((2, 40, 48), seed=32), 2, wavelet="db2_copy")
    assert ts.layout == js.layout == "global"
    _assert_streams_close(ts, js)
    _assert_cross_decodes(ts, js, decodes=((True, 0.5),))


@pytest.mark.parametrize("mode", ["replicate", "reflect", "constant"])
def test_uint16_lossless_roundtrip_matches_jax(mode):
    """uint16 input (bit_depth 16 inferred) on the 9-16-bit path: global
    layout, int32 codes, bit for bit against JAX and the input."""
    x = np.random.default_rng(33).integers(0, 65536, size=(3, 30, 44), dtype=np.uint16)
    ts = tpipe.encode(torch.from_numpy(x), levels=3, wavelet="legall5.3", color="rct", mode=mode, constant=7)
    js = jpipe.encode(x, levels=3, wavelet="legall5.3", color="rct", mode=mode, constant=7)
    assert (ts.bit_depth, ts.layout) == (js.bit_depth, js.layout) == (16, "global")
    for t, j in zip([ts.ll] + flat(ts.details), [js.ll] + flat(js.details)):
        assert t.dtype == torch.int32 and t.shape == j.shape
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    rec = tpipe.decode(ts, emit_u8=True)
    assert rec.dtype == torch.uint16
    np.testing.assert_array_equal(rec.numpy(), x)
    np.testing.assert_array_equal(rec.numpy(), np.asarray(jpipe.decode(js, emit_u8=True)))
    np.testing.assert_array_equal(tpipe.decode(ts).numpy(), np.asarray(jpipe.decode(js)))
    np.testing.assert_array_equal(tpipe.decode_at_level(ts, 2, emit_u8=True).numpy(),
                                  np.asarray(jpipe.decode_at_level(js, 2, emit_u8=True)))
    np.testing.assert_array_equal(tpipe.icon_from_stream(ts).numpy(), np.asarray(jpipe.icon_from_stream(js)))
    np.testing.assert_array_equal(tpipe.decode_region(ts, 5, 20, 9, 40, emit_u8=True).numpy(), x[..., 5:20, 9:40])


def test_hi_depth_haar_int_matches_jax():
    x = np.random.default_rng(34).integers(0, 4096, size=(1, 20, 28), dtype=np.uint16)
    ts = tpipe.encode(torch.from_numpy(x), levels=2, wavelet="haar_int", bit_depth=12)
    js = jpipe.encode(x, levels=2, wavelet="haar_int", bit_depth=12)
    assert (ts.bit_depth, ts.layout, ts.details[0][0].dtype) == (12, "global", torch.int32)
    np.testing.assert_array_equal(tpipe.decode(ts, emit_u8=True).numpy(), x)
    np.testing.assert_array_equal(tpipe.decode_at_level(ts, 1).numpy(), np.asarray(jpipe.decode_at_level(js, 1)))


def test_bit_depth_12_float_matches_jax():
    """bior4.4 at bit_depth 12 (uint8 samples): whole-image lifting, int32
    codes within the tolerance, uint16 output."""
    x = _u8((3, 36, 52), seed=35)
    ts, js = _encode_both(x, 3, wavelet="bior4.4", color="ict", bit_depth=12)
    _assert_streams_close(ts, js)
    assert ts.details[0][0].dtype == torch.int32
    port_from_jax = _port_from_jax(js)
    got = tpipe.decode(port_from_jax, emit_u8=True)
    assert got.dtype == torch.uint16
    assert_close(got.to(torch.int32), np.asarray(jpipe.decode(js, emit_u8=True)).astype(np.int32), "uint16")
    assert_close(tpipe.decode(port_from_jax), jpipe.decode(js), "float32")
    with pytest.raises(ValueError):
        tpipe.encode(x, levels=3, bit_depth=12, device="cpu")  # haar has no high-bit-depth path
    with pytest.raises(ValueError):
        tpipe.encode(x, levels=3, wavelet="bior4.4", bit_depth=17, device="cpu")
