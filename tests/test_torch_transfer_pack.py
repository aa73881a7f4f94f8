"""PACK1, the packed stream transfer of the port (``wicca_tpu_torch.codec.
transfer`` with ``ops/pack_cuda.py`` and ``native/pack.cpp``), against the
JAX package's (``wicca_tpu.codec.transfer``) on the CPU.

Streams are encoded once by the port (``device='cpu'``) and carried to the
JAX package with ``codec/interop.py``; the JAX side runs with
``force=True``, as ``tests/test_transfer.py`` runs it (its stats, pack and
unpack are jnp under ``jax.jit``, no Pallas). Tolerance 0: the field bytes,
the zigzag codes, P1's statistics, the sticky (k, C) choices over a
sequence of streams, the whole packed buffer (escape rows' padding and raw
passthrough included), the upload's parts, the planes both directions land,
and ``serialize`` bytes. The kernels themselves are held against these
twins in ``tests/test_torch_kernels_host.py`` (host build) and on the card
by ``chip_smoke.py``."""

import functools
import sys
import types

import cv2
import numpy as np
import pytest
import torch

from tests.test_torch_codec_streams import _jax_stream
from tests.test_torch_dwt97 import one_torch_thread  # noqa: F401 (fixture)
from wicca_tpu.codec import container as jcont
from wicca_tpu.codec import transfer as jtr
from wicca_tpu_torch.codec import batch as tbatch
from wicca_tpu_torch.codec import container as tcont
from wicca_tpu_torch.codec import pipeline as tpipe
from wicca_tpu_torch.codec import transfer as ttr
from wicca_tpu_torch.codec.interop import stream_to_arrays
from wicca_tpu_torch.core.quant import QuantSpec
from wicca_tpu_torch.ops import pack_cuda


def _img(seed=0, shape=(3, 160, 192)):
    return np.random.default_rng(seed).integers(0, 256, size=shape, dtype=np.uint8)


def _smooth(seed, sigma=2.0, shape=(3, 160, 192)):
    """A ramp with Gaussian noise: packs well, with some escapes."""
    c, h, w = shape
    base = np.tile(np.linspace(0, 191, w, dtype=np.float32), (c, h, 1))
    n = np.random.default_rng(seed).normal(0, sigma, base.shape)
    return np.clip(base + n, 0, 255).astype(np.uint8)


def _noise_block():
    """A smooth frame with a block of noise: the finest planes' worst
    segments hold more escapes than any capacity, so they pass raw."""
    x = _smooth(5, 3.0)
    x[:, :40, :48] = _img(2)[:, :40, :48]
    return x


# case -> (frame, encode options); every stream's planes are int8 or int16
STREAMS = {
    "haar": (lambda: _smooth(1, 6.0), dict(levels=3, spec=QuantSpec(base_step=1.0))),
    "legall5.3": (lambda: _smooth(2, 6.0), dict(levels=3, wavelet="legall5.3")),
    "bior4.4": (lambda: _smooth(3, 6.0), dict(levels=3, spec=QuantSpec(base_step=1.0), wavelet="bior4.4")),
    "gray-odd": (lambda: _smooth(4, 6.0, (1, 300, 340)), dict(levels=2, spec=QuantSpec(base_step=2.0))),
    "noise-raw": (lambda: _noise_block(), dict(levels=3, spec=QuantSpec(base_step=1.0))),
}


@functools.lru_cache(maxsize=None)
def _stream(case):
    make, opts = STREAMS[case]
    return tpipe.encode(make(), device="cpu", **opts)


def _jax(ts):
    return _jax_stream(*stream_to_arrays(ts))


@pytest.fixture(autouse=True)
def fresh_sticky_choices():
    ttr._STICKY_KCS.clear()
    jtr._STICKY_KCS.clear()
    yield
    ttr._STICKY_KCS.clear()
    jtr._STICKY_KCS.clear()


def _assert_same_planes(a, b):
    for x, y in zip(ttr._planes(a), ttr._planes(b), strict=True):
        assert x.dtype == y.dtype and x.shape == y.shape and x.device.type == "cpu"
        assert torch.equal(x, y)


def _jax_meta(js):
    planes = jtr._stream_planes(js)
    return planes, jtr._plane_meta([(p.shape, np.dtype(p.dtype).name) for p in planes])


def _port_meta(ts):
    planes = ttr._stream_planes(ts)
    return planes, ttr._plane_meta([(tuple(p.shape), p.dtype) for p in planes])


# ---- fields and zigzag ----


@pytest.mark.parametrize("width,k", [(8, k) for k in range(1, 8)] + [(16, k) for k in range(1, 16)])
def test_field_bytes_match_jax(width, k):
    rng = np.random.default_rng(100 * width + k)
    z = rng.integers(0, 1 << k, 8 * 389).astype(np.uint8 if width == 8 else np.uint16)
    z[:8] = (1 << k) - 1  # the marker in every slot of a group
    want = jtr._pack_fields_np(z, k)
    got = pack_cuda.pack_fields(torch.from_numpy(z.astype(np.int32)), k)
    assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), want)
    assert np.array_equal(pack_cuda.unpack_fields(got, k).numpy(), z.astype(np.int32))
    assert np.array_equal(jtr._unpack_fields_np(want, k, z.size, width), z)


def test_zigzag_full_range_matches_jax():
    for width, dt in ((8, np.int8), (16, np.int16)):
        c = np.arange(np.iinfo(dt).min, np.iinfo(dt).max + 1, dtype=dt)
        z = ttr._zigzag(torch.from_numpy(c), width)
        assert np.array_equal(z.numpy(), jtr._zigzag_np(c, width).astype(np.int32))
        back = ttr._unzigzag(z, width)
        assert back.dtype == (torch.int8 if width == 8 else torch.int16) and np.array_equal(back.numpy(), c)
    assert int(ttr._zigzag(torch.tensor([-32768], dtype=torch.int16), 16)) == 65535
    assert int(ttr._zigzag(torch.tensor([-128], dtype=torch.int8), 8)) == 255


# ---- device -> host: statistics, choices, the buffer ----


@pytest.mark.parametrize("case", ["haar", "legall5.3", "gray-odd"])
def test_stats_match_jax(case):
    ts = _stream(case)
    jplanes, jmeta = _jax_meta(_jax(ts))
    tplanes, tmeta = _port_meta(ts)
    got = pack_cuda.pack1_stats(tplanes)
    want = np.asarray(jtr._stats_fn(jmeta)(jplanes))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert [(m.shape, m.width, m.n, m.npad) for m in tmeta] == [(m.shape, m.width, m.n, m.npad) for m in jmeta]


def test_sticky_choices_over_a_sequence_match_jax():
    """Frames of one geometry: the first choice sticks while it stays
    valid, a dense frame forces a new one; each step as in JAX."""
    frames = [_smooth(20), _smooth(21, 1.0), np.random.default_rng(5).integers(0, 256, (3, 160, 192), np.uint8),
              _smooth(23)]
    steps = [1.0, 1.0, 0.05, 1.0]
    seen, fresh = [], []
    for x, step in zip(frames, steps):
        ts = tpipe.encode(x, levels=2, spec=QuantSpec(base_step=step), device="cpu")
        jplanes, jmeta = _jax_meta(_jax(ts))
        tplanes, tmeta = _port_meta(ts)
        stats = pack_cuda.pack1_stats(tplanes).numpy()
        want = jtr._choose_kcs_sticky(np.asarray(jtr._stats_fn(jmeta)(jplanes)), jmeta)
        assert ttr._choose_kcs_sticky(stats, tmeta) == want
        offs = np.cumsum([0] + [m.width - 1 for m in tmeta])
        fresh.append([ttr._choose_kc(stats[o : o + m.width - 1], m) for m, o in zip(tmeta, offs)])
        assert fresh[-1] == [jtr._choose_kc(stats[o : o + jm.width - 1], jm) for jm, o in zip(jmeta, offs)]
        seen.append(want)
    assert seen[1] == seen[0] != tuple(fresh[1])  # kept while valid, where a fresh choice differs
    assert seen[2] == tuple(fresh[2]) != seen[0]  # then chosen anew


@pytest.mark.parametrize("case", list(STREAMS))
def test_packed_buffer_matches_jax(case):
    ts = _stream(case)
    js = _jax(ts)
    jplanes, jmeta = _jax_meta(js)
    tplanes, tmeta = _port_meta(ts)
    kcs = ttr._choose_kcs_sticky(pack_cuda.pack1_stats(tplanes).numpy(), tmeta)
    assert kcs == jtr._choose_kcs_sticky(np.asarray(jtr._stats_fn(jmeta)(jplanes)), jmeta)
    assert any(k < m.width for (k, _), m in zip(kcs, tmeta))
    if case == "noise-raw":
        assert any(k == m.width for (k, _), m in zip(kcs, tmeta))  # the raw passthrough runs
    if case == "gray-odd":
        assert all(m.n % pack_cuda.SEG for m in tmeta)  # every plane ends in a padded segment
    want = np.asarray(jtr._pack_fn(jmeta, kcs, tuple(js.ll.shape), np.dtype(js.ll.dtype).name)(jplanes, js.ll))
    got = pack_cuda.pack1_pack(tplanes, kcs, ts.ll)
    ll_bytes = ttr._ll_nbytes(ts.ll.shape, ts.ll.dtype)
    assert got.numel() == ttr.packed_nbytes(tmeta, kcs, ll_bytes) == jtr.packed_nbytes(jmeta, kcs, ll_bytes)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", ["haar", "legall5.3", "bior4.4", "gray-odd", "noise-raw"])
def test_fetch_stream_force_is_exact_and_serializes_as_jax(case):
    ts = _stream(case)
    packed = ttr.fetch_stream(ts, force=True)
    assert packed is not ts  # packing paid: the planes were rebuilt
    _assert_same_planes(packed, ttr.fetch_stream(ts, force=False))
    assert ttr.fetch_stream(ts) is ts  # a host stream stays as it is
    jpacked = jtr.fetch_stream(_jax(ts), force=True)
    assert tcont.serialize(packed) == jcont.serialize(jpacked) == tcont.serialize(ts)


def test_fetch_stream_int32_planes_move_plainly():
    x16 = np.random.default_rng(5).integers(0, 4096, (1, 64, 64), dtype=np.uint16)
    ts = tpipe.encode(x16, levels=2, wavelet="legall5.3", bit_depth=12, device="cpu")
    assert not ttr._packable(ts)
    assert ttr.fetch_stream(ts, force=True) is ts


# ---- host -> device ----


@pytest.mark.parametrize("case", ["haar", "legall5.3", "noise-raw"])
def test_put_stream_force_is_exact_and_packs_as_jax(case):
    ts = _stream(case)
    _assert_same_planes(ttr.put_stream(ts, "cpu", force=True), ts)
    js = _jax(ts)
    for tp, (jp, jm), tm in zip(ttr._stream_planes(ts), zip(*_jax_meta(js)), _port_meta(ts)[1]):
        flat = tp.numpy().reshape(-1)
        assert np.array_equal(ttr._tail_counts(flat, tm), jtr._tail_counts_np(jtr._zigzag_np(flat, tm.width), tm.width))
        (tkb, tparts), (jkb, jparts) = ttr._pack_plane_host(tp.numpy(), tm), jtr._pack_plane_host(np.asarray(jp), jm)
        assert tkb == jkb and len(tparts) == len(jparts)
        assert all(a.dtype == b.dtype and np.array_equal(a, b) for a, b in zip(tparts, jparts))
    jdev = jtr.put_stream(jtr.fetch_stream(js, force=False), force=True)
    assert tcont.serialize(ttr.put_stream(ts, "cpu", force=True)) == jcont.serialize(jdev)


def test_put_stream_empty_corrections():
    ts = tpipe.encode(np.full((3, 128, 128), 128, np.uint8), levels=2, spec=QuantSpec(base_step=4.0), device="cpu")
    _, meta = _port_meta(ts)
    packed = [ttr._pack_plane_host(p.numpy(), m) for p, m in zip(ttr._stream_planes(ts), meta)]
    assert all(kb == (1, 0) and len(parts) == 1 for kb, parts in packed)
    buf, layout = ttr._upload_buffer(meta, packed, pinned=False)
    assert all(u.ncorr == 0 and u.off % 16 == 0 for u in layout)
    _assert_same_planes(ttr.put_stream(ts, "cpu", force=True), ts)


def test_put_stream_corrections_and_buckets():
    """Planes with escapes at the end of a padded segment and a bucket
    padded with repeats: the upload layout P3 reads lands every plane."""
    ts = _stream("legall5.3")
    _, meta = _port_meta(ts)
    packed = [ttr._pack_plane_host(p.numpy(), m) for p, m in zip(ttr._stream_planes(ts), meta)]
    assert any(b and b > 16 for (_, b), _ in packed)
    buf, layout = ttr._upload_buffer(meta, packed, pinned=False)
    assert all(u.pos_off % 4 == 0 for u in layout)
    got = pack_cuda.pack1_unpack(buf, layout)
    for g, p in zip(got, ttr._stream_planes(ts)):
        assert torch.equal(g, p)


# ---- the gate ----


def test_enabled_gate(monkeypatch):
    monkeypatch.setenv("WICCA_TPU_PACKED_TRANSFER", "off")
    assert not ttr.enabled()
    monkeypatch.setenv("WICCA_TPU_PACKED_TRANSFER", "on")
    assert ttr.enabled()
    for mode in ("auto", "AUTO"):
        monkeypatch.setenv("WICCA_TPU_PACKED_TRANSFER", mode)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        assert not ttr.enabled()  # no card
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        # each way breaks even at its own rate: a link between the two packs downloads only
        monkeypatch.setattr(ttr, "link_bandwidth", lambda probe=False, device=None: 4e8)
        assert ttr.enabled() and ttr.enabled("down", 8) and not ttr.enabled("up", 8)
        assert ttr.enabled("down", 16) and ttr.enabled("up", 16)
        for (direction, width), below in ttr._PACK_BELOW_BYTES_PER_S.items():
            for rate, want in ((below * 0.9, True), (below * 1.1, False), (None, False)):
                monkeypatch.setattr(ttr, "link_bandwidth", lambda probe=False, device=None, r=rate: r)
                assert ttr.enabled(direction, width) == want
    monkeypatch.delenv("WICCA_TPU_PACKED_TRANSFER")
    assert not ttr.enabled()


# ---- the folder pipeline ----


def test_folder_bytes_equal_with_packing_on(tmp_path, monkeypatch):
    src = tmp_path / "in"
    src.mkdir()
    for i in range(3):
        cv2.imwrite(str(src / f"f{i}.png"), _smooth(40 + i, 8.0).transpose(1, 2, 0).copy())
    outs, recs = {}, {}
    for mode in ("off", "on"):
        monkeypatch.setenv("WICCA_TPU_PACKED_TRANSFER", mode)
        out, rec = tmp_path / f"wct_{mode}", tmp_path / f"rec_{mode}"
        tbatch.encode_folder(src, out, levels=3, spec=QuantSpec(base_step=1.0), path="device", threads=2,
                             device="cpu")
        tbatch.decode_folder(out, rec, path="device", threads=2, device="cpu")
        outs[mode] = {p.name: p.read_bytes() for p in sorted(out.glob("*.wct"))}
        recs[mode] = {p.name: p.read_bytes() for p in sorted(rec.glob("*.png"))}
    assert outs["on"] == outs["off"] and len(outs["on"]) == 3
    assert recs["on"] == recs["off"] and len(recs["on"]) == 3


# ---- fetch_keras_weights ----


def _fake_keras(monkeypatch, module, write):
    """A keras.applications stand-in: ``MobileNetV2(weights=...)`` whose
    ``save_weights`` writes an H5 through ``write``."""
    fake = types.ModuleType("fake_keras_applications")

    class MobileNetV2:
        def __init__(self, weights):
            assert weights == "imagenet"

        def save_weights(self, path):
            write(path)

    fake.MobileNetV2 = MobileNetV2
    monkeypatch.setitem(sys.modules, fake.__name__, fake)
    monkeypatch.setitem(module._KERAS_FACTORIES, "MobileNetV2", (fake.__name__, "MobileNetV2"))


@pytest.mark.parametrize("package", ["jax", "port"])
def test_fetch_keras_weights_writes_a_convertible_h5(package, tmp_path, monkeypatch):
    pytest.importorskip("h5py")
    from tests.test_torch_convert import _synthetic, _write_keras_h5
    from wicca_tpu.models import convert as jcw
    from wicca_tpu_torch.models import convert as cw

    _, layers, _ = _synthetic("MobileNetV2", tmp_path)
    module = jcw if package == "jax" else cw
    _fake_keras(monkeypatch, module, lambda path: _write_keras_h5(path, layers))
    h5 = module.fetch_keras_weights("MobileNetV2", tmp_path)
    assert h5 == tmp_path / "MobileNetV2_imagenet.h5" and h5.is_file()
    out = cw.convert_h5("MobileNetV2", h5, tmp_path / "weights")
    assert out == tmp_path / "weights" / "MobileNetV2.msgpack" and out.stat().st_size > 0


@pytest.mark.parametrize("package", ["jax", "port"])
def test_fetch_keras_weights_without_tensorflow_raises(package, monkeypatch):
    from wicca_tpu.models import convert as jcw
    from wicca_tpu_torch.models import convert as cw

    module = jcw if package == "jax" else cw
    monkeypatch.setitem(module._KERAS_FACTORIES, "MobileNetV2", ("no_such_tensorflow.keras.applications",
                                                                 "MobileNetV2"))
    with pytest.raises(RuntimeError, match="tensorflow is required"):
        module.fetch_keras_weights("MobileNetV2", "unused")

