"""More of the port's Haar codec against ``wicca_tpu.codec.pipeline`` on the
CPU: float input, JAX's tile padding, R-D divisors, and streams decoded
across the two packages through ``wicca_tpu_torch.codec.interop``.
Tolerance 0 throughout."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

import wicca_tpu.ops.dwt_pallas as dp
from tests.test_torch_codec import SPECS, _assert_decodes_equal, _assert_streams_equal, _encode_both, _u8
from wicca_tpu.codec import pipeline as jpipe
from wicca_tpu.core.quant import QuantSpec as JaxQuantSpec
from wicca_tpu_torch.codec.interop import stream_from_arrays, stream_to_arrays


def _jax_stream(ll, details, meta):
    spec = dict(meta["spec"], coeff_dtype=jnp.dtype(meta["spec"]["coeff_dtype"]))
    rest = {k: v for k, v in meta.items() if k != "spec"}
    return jpipe.CodeStream(
        ll=jnp.asarray(ll), details=tuple(tuple(jnp.asarray(b) for b in bands) for bands in details),
        spec=JaxQuantSpec(**spec), **rest,
    )


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("levels", [2, 5])
def test_encode_decode_float_matches_jax(levels, spec):
    x = (np.random.default_rng(levels).random((2, 37, 66)) * 290 - 17).astype(np.float32)
    ts, js = _encode_both(x, levels, SPECS[spec])
    _assert_streams_equal(ts, js)
    _assert_decodes_equal(ts, js)


def test_tile_padding_shapes(monkeypatch):
    # shrink JAX's tiles so its kernels pad to tiles at a small size; the
    # port works on semantic extents and must store the same shapes. The
    # shape is used by no other test (jit caches traces by shape).
    monkeypatch.setattr(dp, "_TILE_H", 32)
    monkeypatch.setattr(dp, "_TILE_W", 64)
    ts, js = _encode_both(_u8((2, 88, 200), seed=9), 4, SPECS["step0.75-hh1.5"])
    _assert_streams_equal(ts, js)
    _assert_decodes_equal(ts, js, [(False, 0.3), (True, 0.5)])


def test_band_div_decode_matches_jax():
    ts, js = _encode_both(_u8((1, 48, 64), seed=10), 4, SPECS["step1"])
    div = tuple(int(d) for d in np.random.default_rng(0).integers(1, 4, size=12))
    _assert_decodes_equal(dataclasses.replace(ts, band_div=div), dataclasses.replace(js, band_div=div),
                          [(False, 0.5), (True, 0.3)])


@pytest.mark.parametrize("levels", [3, 5])
def test_cross_decode_through_interop(levels):
    x = _u8((3, 50, 61), seed=11 + levels)
    ts, js = _encode_both(x, levels, SPECS["step0.75-hh1.5"])
    # JAX-encoded stream decoded by the port
    meta = {f.name: getattr(js, f.name) for f in dataclasses.fields(js) if f.name not in ("ll", "details")}
    port_from_jax = stream_from_arrays(np.asarray(js.ll), [[np.asarray(b) for b in bands] for bands in js.details],
                                       device="cpu", **meta)
    assert port_from_jax.spec == ts.spec
    _assert_decodes_equal(port_from_jax, js)
    # port-encoded stream decoded by JAX
    ll, details, meta = stream_to_arrays(ts)
    jax_from_port = _jax_stream(ll, details, meta)
    _assert_streams_equal(ts, jax_from_port)
    _assert_decodes_equal(ts, jax_from_port)
    # and back again
    again = stream_from_arrays(ll, details, device="cpu", **meta)
    _assert_streams_equal(again, js)
