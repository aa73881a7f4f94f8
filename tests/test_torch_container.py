"""The port's ``.wct`` container (``wicca_tpu_torch.codec.container``) and
``transcode`` against ``wicca_tpu.codec`` on the CPU.

Streams are encoded once by the port (``device='cpu'``) and carried to the
JAX package with ``codec/interop.py``, so no Pallas encode runs. For every
case the two ``serialize`` give the same bytes, each package deserializes
the other's bytes to the same stream (values, dtypes, shapes and fields),
``inspect`` and ``peek_layers`` agree, and the loaded stream decodes as the
stream itself. The WCT1-WCT3 files are built as
``tests/test_container_versions.py`` builds them. Tolerance 0, except the
port's decode of the WCT1 global db2 file against JAX's, within the float
tolerance of ``tests/test_torch_dwt97.py``."""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

from tests.test_container_versions import _global_float_stream, _serialize_legacy, _serialize_v1
from tests.test_torch_codec import _assert_streams_equal
from tests.test_torch_codec_streams import _jax_stream
from tests.test_torch_dwt97 import assert_close, one_torch_thread  # noqa: F401 (fixture)
from wicca_tpu.codec import container as jcont
from wicca_tpu.codec import pipeline as jpipe
from wicca_tpu.core.quant import QuantSpec as JaxQuantSpec
from wicca_tpu_torch.codec import container as tcont
from wicca_tpu_torch.codec import pipeline as tpipe
from wicca_tpu_torch.codec.interop import stream_from_arrays, stream_to_arrays
from wicca_tpu_torch.core.quant import QuantSpec

# the modules (each package's codec/__init__ exports a function of the same name)
jtrans = importlib.import_module("wicca_tpu.codec.transcode")
ttrans = importlib.import_module("wicca_tpu_torch.codec.transcode")
FIELDS = ("wavelet", "color", "chroma_gain", "layout", "bit_depth", "roi_shift", "bg_shift", "metadata", "band_div")


def _smooth(shape, seed, peak=255):
    """Smooth content with noise (pure noise defeats the deadzone)."""
    rng = np.random.default_rng(seed)
    c, h, w = shape
    base = rng.integers(0, peak + 1, (c, -(-h // 8), -(-w // 8))).astype(np.float32)
    up = np.kron(base, np.ones((1, 8, 8), np.float32))[:, :h, :w] + rng.normal(0, peak / 60, shape)
    return np.clip(up, 0, peak)


# case -> (encode options, stream changes, serialize options)
CASES = {
    "haar": (dict(wavelet="haar"), {}, dict()),
    "haar-layers3-rc": (dict(wavelet="haar"), {}, dict(quality_layers=3, codec="rc")),
    "haar-step0.75-rice-nocrc": (dict(wavelet="haar", spec=dict(base_step=0.75)), {},
                                 dict(codec="rice", checksums=False)),
    "haar_int-llrice": (dict(wavelet="haar_int"), {}, dict(ll_codec="rice")),
    "haar_int-layers3-nocrc": (dict(wavelet="haar_int"), {}, dict(quality_layers=3, checksums=False)),
    "legall5.3-rct": (dict(wavelet="legall5.3", color="rct"), {}, dict()),
    "legall5.3-rct-layers3-rice": (dict(wavelet="legall5.3", color="rct"), {}, dict(quality_layers=3, codec="rice")),
    "legall5.3-llrice-layers3": (dict(wavelet="legall5.3"), {}, dict(ll_codec="rice", quality_layers=3)),
    "cdf97-ict": (dict(wavelet="cdf97", color="ict", chroma_gain=2.0), {}, dict()),
    "bior4.4-hh1.5": (dict(wavelet="bior4.4", spec=dict(base_step=0.75, hh_gain=1.5)), {}, dict(codec="rc")),
    "cdf97-llquant": (dict(wavelet="cdf97"), {}, dict(ll_codec="quant", ll_step=0.25)),
    "db2-layers3-rc": (dict(wavelet="db2"), {}, dict(quality_layers=3, codec="rc")),
    "haar-metadata-layers3": (dict(wavelet="haar"), dict(metadata=(("exif", b"\x00\x01raw"), ("note", "é".encode()))),
                              dict(quality_layers=3)),
    "haar-banddiv-metadata": (dict(wavelet="haar"), dict(band_div=(2, 3, 1, 4, 1, 1, 1, 2, 1),
                                                         metadata=(("k", b"v"),)), dict()),
    "haar-banddiv-llquant": (dict(wavelet="haar"), dict(band_div=(1, 1, 6, 1, 1, 1, 1, 1, 255)),
                             dict(ll_codec="quant", codec="rice")),
    "legall5.3-12bit": (dict(wavelet="legall5.3", bit_depth=12), {}, dict()),
    "cdf97-12bit-layers3": (dict(wavelet="cdf97", bit_depth=12), {}, dict(quality_layers=3)),
}


def _port_stream(enc: dict, changes: dict, seed: int):
    enc = dict(enc)
    spec = QuantSpec(**enc.pop("spec", {}))
    depth = enc.get("bit_depth", 8)
    x = _smooth((3, 44, 72), seed, (1 << depth) - 1).astype(np.uint16 if depth > 8 else np.uint8)
    ts = tpipe.encode(x, levels=3, spec=spec, device="cpu", **enc)
    return dataclasses.replace(ts, **changes), x


def _jax_of(ts):
    return _jax_stream(*stream_to_arrays(ts))


def _assert_same(ts, other) -> None:
    """Port stream ``ts`` equals ``other`` (a port or a JAX stream)."""
    _assert_streams_equal(ts, other)
    for name in FIELDS:
        assert getattr(ts, name) == (tuple(getattr(other, name)) if name == "band_div" else getattr(other, name)), name
    for name in ("base_step", "level_gain", "hh_gain"):
        assert getattr(ts.spec, name) == getattr(other.spec, name), name


@pytest.mark.parametrize("case", CASES)
def test_same_bytes_and_cross_loading(case):
    enc, changes, opts = CASES[case]
    ts, _ = _port_stream(enc, changes, seed=len(case))
    js = _jax_of(ts)
    blob = tcont.serialize(ts, **opts)
    assert blob == jcont.serialize(js, **opts)
    assert tcont.inspect(blob) == jcont.inspect(blob)
    assert tcont.peek_layers(blob) == jcont.peek_layers(blob) == opts.get("quality_layers", 1)
    back = tcont.deserialize(blob, device="cpu")  # the port reads the reference's bytes
    jback = jcont.deserialize(blob)  # and the reference the port's
    _assert_same(back, jback)
    if opts.get("ll_codec") != "quant":  # the quantized LL is not the stream's LL
        _assert_same(back, ts)
        assert torch.equal(tpipe.decode(back, emit_u8=True), tpipe.decode(ts, emit_u8=True))
    if opts.get("quality_layers", 1) > 1:
        for keep in (1, 2):
            _assert_same(tcont.deserialize(blob, max_layers=keep, device="cpu"), jcont.deserialize(blob, max_layers=keep))


def test_truncated_prefix_and_corrupt_planes_match_the_reference():
    ts, _ = _port_stream(dict(wavelet="haar"), {}, seed=5)
    layered = tcont.serialize(ts, quality_layers=3, checksums=False)
    cut = len(layered) - (len(layered) - len(tcont.serialize(ts, checksums=False))) // 4
    _assert_same(tcont.deserialize(layered[:cut], allow_truncated=True, device="cpu"),
                 jcont.deserialize(layered[:cut], allow_truncated=True))
    for fn in (lambda b: tcont.deserialize(b, device="cpu"), jcont.deserialize):
        with pytest.raises(ValueError, match="truncated"):
            fn(layered[:cut])
    for quality_layers in (1, 3):
        blob = bytearray(tcont.serialize(ts, quality_layers=quality_layers))
        ends = tcont._read_trailer(bytes(blob), 1 + 9 * quality_layers)
        blob[(ends[4][0] + ends[5][0]) // 2] ^= 0xFF  # a byte inside the fifth plane section
        bad = bytes(blob)
        assert tcont.inspect(bad)["corrupt_sections"] == jcont.inspect(bad)["corrupt_sections"] == ["section 5"]
        for fn in (lambda b: tcont.deserialize(b, device="cpu"), jcont.deserialize):
            with pytest.raises(ValueError, match="corrupt"):
                fn(bad)
        _assert_same(tcont.deserialize(bad, on_error="zero", device="cpu"), jcont.deserialize(bad, on_error="zero"))


def test_wct1_global_db2_file():
    """A WCT1 db2 file of the whole-image era (layout 'global'), built as
    tests/test_container_versions.py:61 builds it, across two row tiles."""
    img = np.random.default_rng(3).integers(0, 256, (1, 1024, 64), np.uint8)
    js = _global_float_stream(img, levels=3, wavelet="db2", spec=JaxQuantSpec(base_step=1.0))
    blob = _serialize_v1(js)
    back = tcont.deserialize(blob, device="cpu")
    jback = jcont.deserialize(blob)
    assert back.layout == "global" and back.wavelet == "db2"
    _assert_same(back, jback)
    assert_close(tpipe.decode(back), jpipe.decode(jback), "WCT1 db2 decode")


@pytest.mark.parametrize("version, wavelet", [(2, "db2"), (3, "haar")])
def test_wct2_wct3_files(version, wavelet):
    ts, _ = _port_stream(dict(wavelet=wavelet), {}, seed=version)
    blob = _serialize_legacy(_jax_of(ts), version)
    back = tcont.deserialize(blob, device="cpu")
    assert back.layout == "tiled"
    _assert_same(back, ts)
    _assert_same(back, jcont.deserialize(blob))
    assert tcont.inspect(blob) == jcont.inspect(blob)


@pytest.mark.parametrize("opts", [
    dict(), dict(max_layers=2), dict(drop_levels=1), dict(codec="rc", quality_layers=1),
    dict(ll_codec="quant", drop_levels=2, max_layers=1),
], ids=["copy", "layers2", "drop1", "rc-flat", "llquant-drop2-layers1"])
def test_transcode_bytes_match_the_reference(opts, tmp_path):
    ts, _ = _port_stream(dict(wavelet="haar"), dict(metadata=(("icc", b"profile"),)), seed=21)
    src = tmp_path / "src.wct"
    tcont.save(ts, src, quality_layers=3)
    got = ttrans.transcode(src, tmp_path / "port.wct", **opts)
    want = jtrans.transcode(src, tmp_path / "ref.wct", **opts)
    assert got == want
    assert (tmp_path / "port.wct").read_bytes() == (tmp_path / "ref.wct").read_bytes()
    out = tcont.load(tmp_path / "port.wct", device="cpu")
    assert out.metadata == ts.metadata


def test_drop_finest_levels_decodes_as_decode_at_level():
    for wavelet in ("haar", "haar_int"):
        ts, _ = _port_stream(dict(wavelet=wavelet), {}, seed=8)
        js = _jax_of(ts)
        small = ttrans.drop_finest_levels(ts, 1)
        _assert_same(small, jtrans.drop_finest_levels(js, 1))
        assert torch.equal(tpipe.decode(small), tpipe.decode_at_level(ts, 1))
    with pytest.raises(ValueError, match="re-root"):
        ttrans.drop_finest_levels(_port_stream(dict(wavelet="legall5.3"), {}, seed=9)[0], 1)


def test_serialize_refusals_and_the_device_rule(monkeypatch):
    ts, _ = _port_stream(dict(wavelet="haar"), {}, seed=1)
    for kw in (dict(codec="zip"), dict(quality_layers=16), dict(ll_codec="rice"), dict(ll_codec="png")):
        with pytest.raises(ValueError):
            tcont.serialize(ts, **kw)
    with pytest.raises(ValueError, match="255 planes"):
        tcont.serialize(dataclasses.replace(ts, ll=ts.ll[:1].expand(256, -1, -1)))
    with pytest.raises(ValueError, match="not a WCT"):
        tcont.deserialize(b"JUNK" + bytes(40), device="cpu")
    blob = tcont.serialize(ts)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcont.deserialize(blob)
    assert tcont.deserialize(blob, device="cpu").ll.device.type == "cpu"


def test_metadata_attach_and_tensor_streams_from_interop():
    ts, _ = _port_stream(dict(wavelet="legall5.3", color="rct"), {}, seed=4)
    meta = {"exif": b"\x00\xff", "note": "hello"}
    tm = tpipe.with_metadata(ts, meta)
    jm = jpipe.with_metadata(_jax_of(ts), meta)
    assert tm.metadata == jm.metadata
    blob = tcont.serialize(tm)
    assert blob[:4] == b"WCT8" and blob == jcont.serialize(jm)
    ll, details, m = stream_to_arrays(tm)
    again = stream_from_arrays(ll, details, device="cpu", **m)
    assert tcont.serialize(again) == blob
    assert tpipe.with_metadata(tm, {}).metadata == ()


def test_layer_prefix_of_a_lossless_file_decodes_as_the_reference():
    """A layer prefix of a lossless container holds int32 widened codes;
    the port's decode reads them as the reference's does (one JAX decode,
    Pallas in interpret mode)."""
    ts, x = _port_stream(dict(wavelet="legall5.3", color="rct"), {}, seed=22)
    blob = tcont.serialize(ts, quality_layers=3)
    back, jback = tcont.deserialize(blob, max_layers=1, device="cpu"), jcont.deserialize(blob, max_layers=1)
    _assert_same(back, jback)
    assert back.details[0][0].dtype == torch.int32
    got, want = tpipe.decode(back, emit_u8=True), jpipe.decode(jback, emit_u8=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    err = got.numpy().astype(np.float64) - x
    assert 0 < np.mean(err * err) < 100  # a lossy preview


def _policy_plane(kind: str) -> np.ndarray:
    """int8 planes for codec='auto': 3 MB ones go through the row-band probe."""
    rng = np.random.default_rng(len(kind))
    if kind == "dense":
        return rng.integers(-40, 41, (3, 1024, 1024)).astype(np.int8)
    if kind == "banded":  # rc's win shows only with contiguous rows
        return np.repeat(rng.integers(-25, 26, (3, 128, 1024)).astype(np.int8), 8, axis=1)
    z = np.zeros((3, 1024, 1024) if kind == "trap" else (3, 256, 256), np.int8)
    for _ in range(3000 if kind == "trap" else 40):
        y, x = rng.integers(0, z.shape[1] - 8), rng.integers(0, z.shape[2] - 8)
        z[:, y : y + 6, x : x + 8] = rng.integers(-12, 13, (3, 6, 8))
    if kind == "trap":  # dense noise exactly where the probe looks: the probe says rice
        for mid in (256, 768):
            z[:, mid - 32 : mid + 32] = rng.integers(-40, 41, (3, 64, 1024))
    return z


@pytest.mark.parametrize("kind", ["dense", "banded", "trap", "clustered"])
def test_auto_codec_policy_matches_the_reference(kind):
    from wicca_tpu_torch.native.rice import rc_encode, rice_encode

    plane = _policy_plane(kind)
    got = tcont._encode_plane(plane, "auto")
    assert got == jcont._encode_plane(plane, "auto")
    assert got[0] == {"dense": 0, "banded": 1, "trap": 0, "clustered": 1}[kind]
    if kind == "trap":  # the full planes would have picked rc: the probe decided
        assert len(rc_encode(plane)) < (1 - tcont._RC_MIN_WIN) * len(rice_encode(plane))
