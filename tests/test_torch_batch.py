"""The port's folder pipeline (``wicca_tpu_torch.codec.batch``
``encode_folder``/``decode_folder``, with ``device='cpu'``: the device route
runs the kernels' plain twins) against the reference's
(``wicca_tpu.codec.batch``) on the same folders of small images.

Tolerance 0: the same ``.wct`` bytes and the same PNG pixels, on both port
routes, and the same metrics keys. The reference runs its host routes only
(``path='host'``), so no Pallas kernel runs here; lossless streams, which
its host encode does not take, are held against
``wicca_tpu.codec.container.serialize`` of the port's stream carried
across with ``codec/interop.py``. Routing is held with the measured rates
patched, as ``tests/test_host_decode.py`` holds the reference's."""

import math

import cv2
import numpy as np
import pytest
import torch

from tests.test_host_decode import photo
from tests.test_torch_codec_streams import _jax_stream
from tests.test_torch_dwt97 import one_torch_thread  # noqa: F401 (fixture)
from wicca_tpu.codec import batch as jbatch
from wicca_tpu.codec import container as jcont
from wicca_tpu.core.quant import QuantSpec as JaxQuantSpec
from wicca_tpu_torch.codec import batch as tbatch
from wicca_tpu_torch.codec import container as tcont
from wicca_tpu_torch.codec import host_decode, host_encode, transfer
from wicca_tpu_torch.codec import pipeline as tpipe
from wicca_tpu_torch.codec.interop import stream_to_arrays
from wicca_tpu_torch.core.quant import QuantSpec

N = 3


def _write_sources(folder, channels=3, seed=30, n=N, shape=(64, 96)):
    folder.mkdir()
    frames = []
    for i in range(n):
        x = photo(*shape, seed=seed + i, channels=channels)
        hwc = np.moveaxis(x, 0, -1)
        if channels == 3:
            hwc = hwc[..., ::-1]
        elif channels == 4:
            hwc = cv2.cvtColor(hwc, cv2.COLOR_RGBA2BGRA)
        cv2.imwrite(str(folder / f"im{i}.png"), hwc)
        frames.append(x)
    (folder / "notes.txt").write_text("not an image")
    return frames


@pytest.fixture(scope="module")
def haar_folders(tmp_path_factory):
    """Sources, the reference's Haar .wct files (host route) and its PNGs."""
    d = tmp_path_factory.mktemp("haar")
    frames = _write_sources(d / "src")
    jm = jbatch.encode_folder(d / "src", d / "jwct", levels=3, spec=JaxQuantSpec(base_step=1.0), path="host",
                              threads=2)
    jdec = {at: jbatch.decode_folder(d / "jwct", d / f"jpng{at}", path="host", threads=2, at_level=at)
            for at in (0, 2)}
    return d, frames, jm, jdec


def _png(path) -> np.ndarray:
    return cv2.imread(str(path), cv2.IMREAD_UNCHANGED)


@pytest.mark.parametrize("path", ["host", "device", "auto"])
def test_haar_folder_bytes_match_the_reference(haar_folders, path, tmp_path):
    d, frames, jm, _ = haar_folders
    m = tbatch.encode_folder(d / "src", tmp_path, levels=3, spec=QuantSpec(base_step=1.0), path=path, threads=2,
                             device="cpu")
    assert list(m) == list(jm)
    assert {k: m[k] for k in ("images", "skipped", "resumed", "megapixels", "bytes_in", "bytes_out", "ratio")} == {
        k: jm[k] for k in ("images", "skipped", "resumed", "megapixels", "bytes_in", "bytes_out", "ratio")}
    # a CPU "device" has no link to cross: auto keeps the device route
    assert (m["host_encoded"], m["device_encoded"]) == ((N, 0) if path == "host" else (0, N))
    for i, x in enumerate(frames):
        got = (tmp_path / f"im{i}.wct").read_bytes()
        assert got == (d / "jwct" / f"im{i}.wct").read_bytes()
        assert got == tcont.serialize(tpipe.encode(x, levels=3, spec=QuantSpec(base_step=1.0), device="cpu"))


@pytest.mark.parametrize("at_level", [0, 2])
@pytest.mark.parametrize("path", ["host", "device"])
def test_decode_folder_pixels_match_the_reference(haar_folders, path, at_level, tmp_path):
    d, frames, _, jdec = haar_folders
    m = tbatch.decode_folder(d / "jwct", tmp_path, path=path, threads=2, at_level=at_level, device="cpu")
    jm = jdec[at_level]
    assert list(m) == list(jm)
    assert {k: m[k] for k in ("images", "resumed", "megapixels", "bytes_in", "bytes_out")} == {
        k: jm[k] for k in ("images", "resumed", "megapixels", "bytes_in", "bytes_out")}
    assert (m["host_decoded"], m["device_decoded"]) == ((N, 0) if path == "host" else (0, N))
    for i, x in enumerate(frames):
        got, want = _png(tmp_path / f"im{i}.png"), _png(d / f"jpng{at_level}" / f"im{i}.png")
        assert got.shape == want.shape and np.array_equal(got, want)
        assert (tmp_path / f"im{i}.png").read_bytes() == (d / f"jpng{at_level}" / f"im{i}.png").read_bytes()
        st = tcont.load(d / "jwct" / f"im{i}.wct", device="cpu")
        ref = tpipe.decode_at_level(st, at_level, emit_u8=True).numpy()
        np.testing.assert_array_equal(np.moveaxis(got[..., ::-1], -1, 0), ref)


def test_lossless_rct_folder_bytes_and_roundtrip(tmp_path):
    """legall5.3 + rct: the host encode does not take it, so both paths
    encode on the device route; the bytes are the reference's serialize of
    the same stream, and both decode routes give the sources bit for bit."""
    frames = _write_sources(tmp_path / "src", seed=40)
    for path in ("host", "device"):
        m = tbatch.encode_folder(tmp_path / "src", tmp_path / f"wct_{path}", levels=4, wavelet="legall5.3",
                                 color="rct", path=path, threads=2, device="cpu")
        assert m["device_encoded"] == N and m["host_encoded"] == 0
    for i, x in enumerate(frames):
        want = jcont.serialize(_jax_stream(*stream_to_arrays(
            tpipe.encode(x, levels=4, wavelet="legall5.3", color="rct", device="cpu"))))
        assert (tmp_path / "wct_host" / f"im{i}.wct").read_bytes() == want
        assert (tmp_path / "wct_device" / f"im{i}.wct").read_bytes() == want
    for path in ("host", "device", "auto"):
        m = tbatch.decode_folder(tmp_path / "wct_host", tmp_path / f"png_{path}", path=path, threads=2,
                                 device="cpu")
        assert m["host_decoded"] == (N if path == "host" else 0)
        for i, x in enumerate(frames):
            np.testing.assert_array_equal(_png(tmp_path / f"png_{path}" / f"im{i}.png")[..., ::-1],
                                          np.moveaxis(x, 0, -1))


def test_float_ict_folder_routes_and_tolerance(tmp_path):
    """bior4.4 + ict: no host route at all (a tiled float wavelet), so every
    frame encodes and decodes on the device route, equal to the in-memory
    decode. Haar + ict forced onto the host route stays within 1 gray level
    of the device route, and ``auto`` keeps it on the device."""
    frames = _write_sources(tmp_path / "src", seed=50)
    spec = QuantSpec(base_step=1.0)
    for wavelet in ("bior4.4", "haar"):
        m = tbatch.encode_folder(tmp_path / "src", tmp_path / wavelet, levels=3, spec=spec, wavelet=wavelet,
                                 color="ict", chroma_gain=2.0, threads=2, device="cpu")
        assert m["device_encoded"] == N
        dev = tbatch.decode_folder(tmp_path / wavelet, tmp_path / f"{wavelet}_dev", threads=2, device="cpu")
        host = tbatch.decode_folder(tmp_path / wavelet, tmp_path / f"{wavelet}_host", path="host", threads=2,
                                    device="cpu")
        assert dev["device_decoded"] == N
        assert host["host_decoded"] == (N if wavelet == "haar" else 0)
        for i, x in enumerate(frames):
            st = tcont.load(tmp_path / wavelet / f"im{i}.wct", device="cpu")
            want = tpipe.decode(st, emit_u8=True).numpy()
            np.testing.assert_array_equal(np.moveaxis(_png(tmp_path / f"{wavelet}_dev" / f"im{i}.png"), -1, 0)[::-1],
                                          want)
            got = np.moveaxis(_png(tmp_path / f"{wavelet}_host" / f"im{i}.png"), -1, 0)[::-1]
            assert np.abs(got.astype(np.int16) - want).max() <= 1


def test_resume_skips_alpha_metadata_and_unreadable_files(tmp_path, caplog):
    frames = _write_sources(tmp_path / "src", channels=4, seed=60)
    (tmp_path / "src" / "zz_broken.png").write_bytes(b"\x89PNG\r\n\x1a\nbroken")
    m = tbatch.encode_folder(tmp_path / "src", tmp_path / "wct", levels=3, wavelet="legall5.3", color="rct",
                             keep_alpha=True, metadata={"rig": "7"}, threads=2, device="cpu")
    assert (m["images"], m["skipped"]) == (N, 1)
    jm = jbatch.encode_folder(tmp_path / "src", tmp_path / "jwct", levels=3, spec=JaxQuantSpec(base_step=1.0),
                              path="host", threads=2)
    assert (jm["images"], jm["skipped"]) == (m["images"], m["skipped"])
    again = tbatch.encode_folder(tmp_path / "src", tmp_path / "wct", resume=True, threads=2, device="cpu")
    assert (again["images"], again["resumed"]) == (0, N)
    d = tbatch.decode_folder(tmp_path / "wct", tmp_path / "png", threads=2, device="cpu")
    assert tbatch.decode_folder(tmp_path / "wct", tmp_path / "png", resume=True, device="cpu")["resumed"] == N
    assert d["images"] == N
    for i, x in enumerate(frames):
        assert tcont.load(tmp_path / "wct" / f"im{i}.wct", device="cpu").metadata == (("rig", b"7"),)
        rgba = cv2.cvtColor(_png(tmp_path / "png" / f"im{i}.png"), cv2.COLOR_BGRA2RGBA)
        np.testing.assert_array_equal(np.moveaxis(rgba, -1, 0), x)
    (tmp_path / "empty").mkdir()
    for fn in (tbatch.encode_folder, tbatch.decode_folder):
        with pytest.raises(ValueError):
            fn(tmp_path / "empty", tmp_path / "out", device="cpu")


def test_routes_follow_the_cost_model(monkeypatch):
    """auto: a slow measured link sends host-decodable frames to the host, a
    fast one (or no link) to the device; a measured device rate counts; the
    forced paths and the environment overrides win; ``auto`` never sends a
    stream to the host where the routes' outputs differ (ict, and Haar steps
    whose dequantization products round), which the reference guards only
    for ict."""
    x = photo(768, 1024, seed=40)
    img = np.moveaxis(x, 0, -1)
    s = host_encode.host_encode(x, levels=3, spec=QuantSpec(base_step=1.0))
    for rate, want in ((40e6, "host"), (20e9, "device"), (math.inf, "device"), (None, "device")):
        monkeypatch.setattr(transfer, "link_bandwidth", lambda probe=False, device=None, r=rate: r)
        assert tbatch._decode_route(s, 0, "auto") == want
        assert tbatch._encode_route(img, "haar", "none", None, False, "auto") == want
    monkeypatch.setattr(transfer, "link_bandwidth", lambda probe=False, device=None: 40e6)
    assert tbatch._decode_route(s, 1, "auto") == "host"  # previews: the upload still dominates
    assert tbatch._decode_route(s, 0, "device") == "device"
    assert tbatch._encode_route(img, "bior4.4", "none", None, False, "host") == "device"  # no host route
    monkeypatch.setenv("WICCA_TPU_DECODE_PATH", "device")
    monkeypatch.setenv("WICCA_TPU_ENCODE_PATH", "device")
    assert tbatch._decode_route(s, 0, "host") == "device"
    assert tbatch._encode_route(img, "haar", "none", None, False, "host") == "device"
    monkeypatch.setenv("WICCA_TPU_DECODE_PATH", "sideways")
    with pytest.raises(ValueError):
        tbatch._decode_route(s, 0, "auto")
    monkeypatch.delenv("WICCA_TPU_DECODE_PATH")
    monkeypatch.delenv("WICCA_TPU_ENCODE_PATH")
    # a fast host and a slow measured device route: host, on a fast link too
    monkeypatch.setattr(transfer, "link_bandwidth", lambda probe=False, device=None: 20e9)
    monkeypatch.setattr(host_decode, "measured_mp_per_s", lambda kind="haar": 1e4)
    monkeypatch.setattr(tbatch, "_device_mps", {"encode": tbatch.RateEMA(1.0), "decode": tbatch.RateEMA(1.0)})
    assert tbatch._decode_route(s, 0, "auto") == "host"
    # the guards: the same fast host, but the routes would differ
    inexact = host_encode.host_encode(x, levels=3, spec=QuantSpec(base_step=0.1))
    ict = tpipe.encode(x, levels=3, spec=QuantSpec(base_step=1.0), color="ict", device="cpu")
    for st in (inexact, ict):
        assert tbatch._decode_route(st, 0, "auto") == "device"
        assert tbatch._decode_route(st, 0, "host") == "host"
    assert host_decode.agrees_with_device(host_encode.host_encode(x, levels=3, spec=QuantSpec(base_step=0.75)))


def test_transfers_on_the_cpu_keep_the_stream():
    s = host_encode.host_encode(photo(64, 96, seed=1), levels=2)
    assert transfer.fetch_stream(s) is s
    moved = transfer.put_stream(s, "cpu")
    assert torch.equal(moved.ll, s.ll) and all(torch.equal(a, b) for da, db in zip(moved.details, s.details)
                                                for a, b in zip(da, db))
    assert transfer.put_array(np.arange(6, dtype=np.uint8), "cpu").tolist() == list(range(6))
    assert transfer.fetch_array_parallel(s.ll) is not None and transfer.fetch_array_parallel(s.ll).dtype == np.float32
