"""The port's lossy float-lifting codec (bior4.4 / cdf97 / db2 on K8/K9,
with and without the irreversible color transform) and its partial decodes
against ``wicca_tpu.codec.pipeline`` on the CPU. The global-layout float
path and the 9-16-bit path are in ``test_torch_codec_global.py``.

Exact: every stream field, and the dtype and tile-padded shape of the LL and
of every code plane; the port's ``decode_region`` against the same crop of
its own ``decode``.

Within the tolerance of ``tests/test_torch_dwt97.py`` (the reference's XLA
build contracts some lifting and ICT products into fused multiply-adds,
depending on the shape): LL and float32 reconstructions ``atol 1e-3``;
codes within 1, in at most 1e-3 of them; uint8 pixels within 1, in at most
1e-3 of them. A code that differs moves the reconstruction around it by
about a step, so reconstructions are compared on one stream: each package
decodes the other's stream through ``codec/interop.py``."""

import dataclasses

import numpy as np
import pytest
import torch

from tests.test_torch_codec_streams import _jax_stream
from tests.test_torch_dwt97 import assert_close, flat, one_torch_thread  # noqa: F401 (fixture)
from wicca_tpu.codec import pipeline as jpipe
from wicca_tpu.core.quant import QuantSpec as JaxQuantSpec
from wicca_tpu_torch.codec import pipeline as tpipe
from wicca_tpu_torch.codec.interop import stream_from_arrays, stream_to_arrays
from wicca_tpu_torch.core.quant import QuantSpec

SPEC = dict(base_step=0.75, hh_gain=1.5)
FIELDS = ("levels", "orig_shape", "wavelet", "color", "chroma_gain", "layout", "bit_depth", "band_div")


def _u8(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, size=shape, dtype=np.uint8)


def _encode_both(x, levels, spec=SPEC, **kw):
    ts = tpipe.encode(x, levels=levels, spec=QuantSpec(**spec), device="cpu", **kw)
    js = jpipe.encode(x, levels=levels, spec=JaxQuantSpec(**spec), **kw)
    return ts, js


def _port_from_jax(js) -> tpipe.CodeStream:
    meta = {f.name: getattr(js, f.name) for f in dataclasses.fields(js) if f.name not in ("ll", "details")}
    return stream_from_arrays(np.asarray(js.ll), [[np.asarray(b) for b in bands] for bands in js.details],
                              device="cpu", **meta)


def _assert_streams_close(ts, js) -> None:
    """Fields, dtypes and shapes exact; LL and codes within the tolerance."""
    assert tuple(getattr(ts, f) for f in FIELDS) == tuple(
        tuple(v) if isinstance(v, (list, tuple)) else v for v in (getattr(js, f) for f in FIELDS))
    assert len(ts.details) == len(js.details) == ts.levels
    assert_close(ts.ll, js.ll, "ll")
    assert_close(flat(ts.details), flat(js.details), "codes")


def _assert_cross_decodes(ts, js, decodes) -> None:
    """Each package decodes the other's stream, within the tolerance."""
    port_from_jax = _port_from_jax(js)
    ll, details, meta = stream_to_arrays(ts)
    jax_from_port = _jax_stream(ll, details, meta)
    for emit_u8, off in decodes:
        assert_close(tpipe.decode(port_from_jax, emit_u8=emit_u8, recon_offset=off),
                     jpipe.decode(js, emit_u8=emit_u8, recon_offset=off), f"port decodes JAX's, emit_u8={emit_u8}")
        assert_close(tpipe.decode(ts, emit_u8=emit_u8, recon_offset=off),
                     jpipe.decode(jax_from_port, emit_u8=emit_u8, recon_offset=off),
                     f"JAX decodes the port's, emit_u8={emit_u8}")


DEPTHS = {
    # levels: (wavelet, color, chroma_gain, planes)
    1: ("cdf97", "none", 1.0, 3),
    2: ("db2", "ict", 1.0, 3),
    3: ("bior4.4", "ict", 2.0, 3),
    4: ("db2", "none", 1.0, 2),
    5: ("bior4.4", "ict", 2.0, 4),
    6: ("cdf97", "ict", 1.0, 4),
}


@pytest.mark.parametrize("levels", DEPTHS)
def test_float_codec_depths_match_jax(levels):
    """Wavelets, ICT with chroma gain 1 and 2, RGBA, depths 1-6; 45 x 70 is
    divisible by 2**levels for no level here. Odd depths decode to float32
    at offset 0.3, even ones to uint8 at offset 0.5."""
    wavelet, color, gain, planes = DEPTHS[levels]
    x = _u8((planes, 45, 70), seed=40 + levels)
    ts, js = _encode_both(x, levels, wavelet=wavelet, color=color, chroma_gain=gain)
    _assert_streams_close(ts, js)
    assert ts.details[0][0].dtype == torch.int16 and ts.ll.dtype == torch.float32
    _assert_cross_decodes(ts, js, decodes=((levels % 2 == 0, 0.3 if levels % 2 else 0.5),))
    port_from_jax = _port_from_jax(js)
    assert_close(tpipe.icon_from_stream(port_from_jax), jpipe.icon_from_stream(js), "icon")
    target = -(-levels // 2)  # a partial pass from depth 4 on
    assert_close(tpipe.decode_at_level(port_from_jax, target, emit_u8=levels % 2 == 1),
                 jpipe.decode_at_level(js, target, emit_u8=levels % 2 == 1), f"decode_at_level {target}")


SEAMS = {
    # (shape, levels, wavelet, color): windows (row0, row1, col0, col1)
    "bior-rows-5": ((1, 1100, 96), 5, "bior4.4", "none", [(520, 700, 10, 90), (0, 40, 0, 96), (1050, 1100, 30, 60)]),
    "db2-cols-4": ((3, 40, 1100), 4, "db2", "ict", [(3, 37, 1000, 1090), (0, 40, 0, 1100)]),
}


@pytest.mark.parametrize("case", SEAMS)
def test_float_codec_across_tile_seams(case):
    """Passes whose inputs pad to (512, 1024) tile multiples: stored shapes
    equal JAX's exactly; decode_at_level crosses a pass; decode_region
    equals the same crop of the port's own decode exactly."""
    shape, levels, wavelet, color, windows = SEAMS[case]
    x = _u8(shape, seed=shape[-1])
    ts, js = _encode_both(x, levels, wavelet=wavelet, color=color, chroma_gain=2.0)
    _assert_streams_close(ts, js)
    _assert_cross_decodes(ts, js, decodes=((True, 0.5),))
    port_from_jax = _port_from_jax(js)
    assert_close(tpipe.decode_at_level(port_from_jax, 2), jpipe.decode_at_level(js, 2), "decode_at_level 2")
    full = tpipe.decode(ts)
    full_u8 = tpipe.decode(ts, emit_u8=True)
    for r0, r1, c0, c1 in windows:
        assert torch.equal(tpipe.decode_region(ts, r0, r1, c0, c1), full[..., r0:r1, c0:c1])
        assert torch.equal(tpipe.decode_region(ts, r0, r1, c0, c1, emit_u8=True), full_u8[..., r0:r1, c0:c1])
    assert tpipe.region_plan(ts, *windows[0]) == jpipe.region_plan(js, *windows[0])


def test_float_region_with_offset_and_divisors_matches_own_decode():
    """decode_region carries recon_offset and R-D divisors into K9's steps."""
    ts = tpipe.encode(_u8((3, 600, 80), seed=7), levels=3, spec=QuantSpec(1.0), wavelet="db2", color="ict",
                      device="cpu")
    ts = dataclasses.replace(ts, band_div=tuple(int(d) for d in np.random.default_rng(1).integers(1, 4, size=9)))
    full = tpipe.decode(ts, recon_offset=0.3)
    assert torch.equal(tpipe.decode_region(ts, 500, 560, 5, 70, recon_offset=0.3), full[..., 500:560, 5:70])
