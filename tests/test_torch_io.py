"""The port's image IO, folder validation, PNG writer and rate tracker
(``wicca_tpu_torch.data.loader``/``validation``/``pngw``,
``wicca_tpu_torch.utils.ema``, C++ in ``wicca_tpu_torch/native/pngw.cpp``)
against the reference's (``wicca_tpu.data``, ``wicca_tpu.utils.ema``) on
the same arrays and files. Tolerance 0: the same PNG bytes, the same loaded
arrays (dtype, shape, values), the same refusals."""

import io
import logging

import cv2
import numpy as np
import pytest
from PIL import Image

from wicca_tpu.data import loader as jload
from wicca_tpu.data import pngw as jpngw
from wicca_tpu.data import validation as jval
from wicca_tpu.utils.ema import RateEMA as JaxRateEMA
from wicca_tpu_torch.data import loader as tload
from wicca_tpu_torch.data import pngw as tpngw
from wicca_tpu_torch.data import validation as tval
from wicca_tpu_torch.utils.ema import RateEMA


def _img(shape, seed, dtype=np.uint8):
    rng = np.random.default_rng(seed)
    peak = np.iinfo(dtype).max
    base = np.linspace(0, peak * 0.8, shape[-1])
    return np.clip(base + rng.normal(0, peak / 18, shape), 0, peak).astype(dtype)


def _read_planar(blob: bytes) -> np.ndarray:
    dec = cv2.imdecode(np.frombuffer(blob, np.uint8), cv2.IMREAD_UNCHANGED)
    if dec.ndim == 2:
        return dec[None]
    dec = cv2.cvtColor(dec, cv2.COLOR_BGRA2RGBA if dec.shape[2] == 4 else cv2.COLOR_BGR2RGB)
    return np.moveaxis(dec, -1, 0)


@pytest.mark.parametrize("threads", [1, 3, 16])
@pytest.mark.parametrize("level,strategy", [(1, 1), (6, 0), (9, 2), (0, 0)])
@pytest.mark.parametrize("shape", [(3, 67, 53), (1, 130, 80), (4, 50, 61), (3, 1, 64)])
def test_encode_png_bytes_match_the_reference(shape, level, strategy, threads):
    x = _img(shape, sum(shape))
    blob = tpngw.encode_png(x, level=level, strategy=strategy, threads=threads)
    assert blob == jpngw.encode_png(x, level=level, strategy=strategy, threads=threads)
    np.testing.assert_array_equal(_read_planar(blob), x)


def test_encode_png_views_gray_and_refusals(tmp_path):
    x = _img((3, 90, 140), 5)
    view = x[:, 10:70, 20:120]  # rows and planes not contiguous
    assert tpngw.encode_png(view) == jpngw.encode_png(view)
    np.testing.assert_array_equal(_read_planar(tpngw.encode_png(view)), view)
    gray = x[0]
    assert tpngw.encode_png(gray) == jpngw.encode_png(gray)
    with Image.open(io.BytesIO(tpngw.encode_png(x))) as im:  # a second reader
        np.testing.assert_array_equal(np.moveaxis(np.asarray(im), -1, 0), x)
    for bad in (x.astype(np.uint16), x[:2], x[None]):
        with pytest.raises(ValueError):
            tpngw.encode_png(bad)
    n = tpngw.write_png(str(tmp_path / "a.png"), x, threads=2)
    assert (tmp_path / "a.png").read_bytes() == jpngw.encode_png(x, threads=2)
    assert n == (tmp_path / "a.png").stat().st_size


def test_write_png_without_the_native_writer_goes_through_cv2(tmp_path, monkeypatch):
    monkeypatch.setenv("WICCA_TPU_NO_NATIVE_PNG", "1")
    assert not tpngw.available() and not jpngw.available()
    with pytest.raises(RuntimeError):
        tpngw.encode_png(np.zeros((1, 4, 4), np.uint8))
    for shape in ((3, 40, 52), (4, 31, 17), (1, 20, 30)):
        x = _img(shape, 7)
        n = tpngw.write_png(str(tmp_path / "t.png"), x)
        jpngw.write_png(str(tmp_path / "j.png"), x)
        assert (tmp_path / "t.png").read_bytes() == (tmp_path / "j.png").read_bytes()
        assert n == (tmp_path / "t.png").stat().st_size
        np.testing.assert_array_equal(_read_planar((tmp_path / "t.png").read_bytes()), x)


@pytest.fixture(scope="module")
def image_files(tmp_path_factory):
    """One file of each kind the loaders meet, written by cv2 and PIL."""
    d = tmp_path_factory.mktemp("images")
    rgb = _img((40, 52, 3), 1)
    cv2.imwrite(str(d / "rgb8.png"), rgb[..., ::-1])
    cv2.imwrite(str(d / "rgb16.png"), _img((40, 52, 3), 2, np.uint16))
    cv2.imwrite(str(d / "gray16.png"), _img((33, 47), 3, np.uint16))
    cv2.imwrite(str(d / "rgba.png"), _img((30, 44, 4), 4))
    cv2.imwrite(str(d / "gray.png"), _img((33, 47), 5))
    cv2.imwrite(str(d / "photo.jpg"), rgb)
    Image.fromarray(rgb).save(d / "pil.bmp")
    Image.fromarray(_img((21, 35), 6)).save(d / "pil_gray.tif")
    (d / "broken.png").write_bytes(b"\x89PNG\r\n\x1a\nnot really")
    (d / "UPPER.PNG").write_bytes((d / "gray.png").read_bytes())
    (d / "notes.txt").write_text("not an image")
    (d / "dir.png").mkdir()
    return d


FILES = ["rgb8.png", "rgb16.png", "gray16.png", "rgba.png", "gray.png", "photo.jpg", "pil.bmp", "pil_gray.tif",
         "broken.png", "missing.png"]


def _same(a, b):
    assert (a is None) == (b is None)
    if a is not None:
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", FILES)
def test_loaders_match_the_reference(image_files, name, caplog):
    p = image_files / name
    with caplog.at_level(logging.CRITICAL):
        _same(tload.load_image(p), jload.load_image(p))
        for keep_alpha in (False, True):
            _same(tload.load_image_raw(p, keep_alpha=keep_alpha), jload.load_image_raw(p, keep_alpha=keep_alpha))
    if name in ("broken.png", "missing.png"):
        assert tload.load_image(p) is None and tload.load_image_raw(p) is None
    if name == "rgb16.png":
        assert tload.load_image_raw(p).dtype == np.uint16
    if name == "rgba.png":
        assert tload.load_image_raw(p, keep_alpha=True).shape[-1] == 4


def test_loader_without_cv2_reads_with_pil(image_files, monkeypatch):
    import builtins

    real = builtins.__import__

    def no_cv2(name, *a, **kw):
        if name == "cv2":
            raise ImportError("no cv2 here")
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_cv2)
    for name in ("rgb8.png", "gray.png", "pil.bmp"):
        _same(tload.load_image(image_files / name), jload.load_image(image_files / name))
    np.testing.assert_array_equal(tload.load_image(image_files / "rgb8.png"), _img((40, 52, 3), 1))


def test_list_images_empty_paths_and_iter_decoded(image_files):
    got = tload.list_images(image_files)
    assert got == jload.list_images(image_files)
    assert [p.name for p in got] == ["UPPER.PNG", "broken.png", "gray.png", "gray16.png", "photo.jpg", "pil.bmp",
                                    "pil_gray.tif", "rgb16.png", "rgb8.png", "rgba.png"]
    for fn in (tload.load_image, tload.load_image_raw):
        with pytest.raises(ValueError):
            fn("")
    paths = [image_files / n for n in FILES[:6]]
    pairs = list(tload.iter_decoded(paths, num_threads=2, prefetch=1))
    assert [p for p, _ in pairs] == paths
    for (_, a), (_, b) in zip(pairs, jload.iter_decoded(paths, num_threads=3, prefetch=2)):
        _same(a, b)
    assert list(tload.iter_decoded([])) == []


def _outcome(fn, *args, **kw):
    try:
        return "ok", fn(*args, **kw)
    except Exception as e:  # noqa: BLE001 (the refusal is what is compared)
        return type(e).__name__, None


def test_folder_validation_matches_the_reference(tmp_path):
    (tmp_path / "empty").mkdir()
    (tmp_path / "full").mkdir()
    (tmp_path / "full" / "a.png").write_bytes(b"")
    (tmp_path / "file").write_text("x")
    for folder in ("missing", "empty", "full", "file"):
        for spec in (tmp_path / folder, str(tmp_path / folder)):
            assert _outcome(tval.validate_input_folder, spec) == _outcome(jval.validate_input_folder, spec)
    assert _outcome(tval.validate_input_folder, 3)[0] == _outcome(jval.validate_input_folder, 3)[0] == "TypeError"
    for folder, overwrite in (("new_t", True), ("full", True), ("full", False), ("empty", False), ("file", True)):
        got = _outcome(tval.validate_output_folder, tmp_path / folder, overwrite=overwrite)
        want = _outcome(jval.validate_output_folder, tmp_path / folder.replace("_t", "_j"), overwrite=overwrite)
        assert got[0] == want[0], folder
    assert (tmp_path / "new_t").is_dir()
    with pytest.raises(ValueError):
        tval.validate_image(np.zeros((0, 4), np.uint8))


def test_rate_ema_matches_the_reference():
    samples = [(1.0, 0.5), (0.1, 0.01), (2.0, 0.0), (3.0, 1.5), (0.3, 0.2), (5.0, 0.5)]
    for prior, alpha, min_units in ((40.0, 0.4, 0.25), (None, 0.4, 0.0), (4.0, 0.9, 1.0)):
        a, b = RateEMA(prior, alpha, min_units), JaxRateEMA(prior, alpha, min_units)
        assert a.rate() == b.rate() == prior
        for units, seconds in samples:
            a.record(units, seconds)
            b.record(units, seconds)
            assert a.rate() == b.rate()
        a.reset()
        assert a.rate() == prior
