"""The port's entropy coders (``wicca_tpu_torch/native``) against the frozen
bitstreams of ``wicca_tpu/native`` on the CPU: the golden Rice and range
coder fixtures of ``tests/test_native.py``, byte identity with the
reference's coders on the same planes, roundtrips and extremes for int8,
int16 and int32, the reference's numpy ``RAW0``/``RAW1`` planes, and a
library that cannot build raising with its compiler command."""

import numpy as np
import pytest

from wicca_tpu.native import rice as jrice
from wicca_tpu_torch.native import rice

# tests/test_native.py:61-72 and :124-129
I8 = np.array([0, 0, 0, 1, -1, 2, -2, 127, -128, 0, 0, 5, -7, 0, 33, -33, 0, 0, 0, 0, 1, 0, -1, 0],
              np.int8).reshape(2, 12)
I16 = np.array([0, 0, 1, -1, 256, -256, 32767, -32768, 0, 3, -3, 1000, -1000, 0, 0, 7], np.int16).reshape(2, 8)
GOLDEN = {
    ("rice", "i8"): "0800800864fefffcffef01a01a3c79010000040800",
    ("rice", "i16"): "1a0000001000020000e13ffcf9ffbfff0f0030000a00e8e3f9000000000700",
    ("rc", "i8"): "00166d66faf2a523eee51129ac8f8edebc3614",
    ("rc", "i16"): "00298e244bb34f47997a3dcddfff161220256bbd5d79ba78beb5ff37",
}
DTYPES = (np.int8, np.int16, np.int32)


@pytest.mark.parametrize("coder, width", sorted(GOLDEN))
def test_golden_bitstreams(coder, width):
    codes = {"i8": I8, "i16": I16}[width]
    golden = bytes.fromhex(GOLDEN[(coder, width)])
    if coder == "rice":
        assert rice.rice_encode(codes) == golden
        np.testing.assert_array_equal(rice.rice_decode(golden, codes.size, codes.dtype).reshape(codes.shape), codes)
    else:
        assert rice.rc_encode(codes) == golden
        np.testing.assert_array_equal(rice.rc_decode(golden, codes.shape, codes.dtype), codes)


def _planes(dtype, seed):
    """Deadzone-like codes (mostly zero, a laplacian tail, clustered
    patches) and the dtype's extremes, as (planes, h, w)."""
    rng = np.random.default_rng(seed)
    info = np.iinfo(dtype)
    lap = np.where(rng.random((3, 41, 67)) < 0.8, 0, np.round(rng.laplace(0, 9, (3, 41, 67))))
    lap[:, 10:20, 5:30] = rng.integers(-60, 61, (3, 10, 25))
    ext = np.resize(np.array([0, info.max, info.min, 1, -1, info.max // 2, info.min // 2]), (2, 13, 29))
    return lap.astype(dtype), ext.astype(dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_same_bytes_as_the_reference_and_roundtrips(dtype):
    for codes in _planes(dtype, seed=np.dtype(dtype).itemsize):
        blob = rice.rice_encode(codes)
        assert blob == jrice.rice_encode(codes)
        np.testing.assert_array_equal(rice.rice_decode(blob, codes.size, dtype).reshape(codes.shape), codes)
        blob = rice.rc_encode(codes)
        assert blob == jrice.rc_encode(codes)
        np.testing.assert_array_equal(rice.rc_decode(blob, codes.shape, dtype), codes)


@pytest.mark.parametrize("shape", [(1, 1), (1, 999), (999, 1), (2, 3, 5), (0, 4)])
def test_rc_adversarial_shapes(shape):
    codes = np.random.default_rng(7).integers(-30, 31, size=shape).astype(np.int8)
    blob = rice.rc_encode(codes)
    assert blob == jrice.rc_encode(codes)
    np.testing.assert_array_equal(rice.rc_decode(blob, shape, np.int8), codes)


def test_empty_and_zero_planes():
    assert rice.rice_encode(np.zeros(0, np.int8)) == b""
    assert rice.rice_decode(b"", 0, np.int8).size == 0
    zeros = np.zeros(4096, np.int8)
    blob = rice.rice_encode(zeros)
    assert blob == jrice.rice_encode(zeros) and len(blob) < 64
    np.testing.assert_array_equal(rice.rice_decode(blob, 4096, np.int8), zeros)


@pytest.mark.parametrize("dtype", DTYPES)
def test_reads_the_reference_numpy_planes(dtype):
    """The reference writes RAW0 (int8, int16) or RAW1 (int32) planes when
    its library is missing; the port reads them, and never writes them."""
    codes = _planes(dtype, seed=3)[1].ravel()
    u = (codes.astype(np.int32) << 1) ^ (codes.astype(np.int32) >> 31)
    raw = b"RAW1" + u.astype(np.uint32).tobytes() if dtype == np.int32 else b"RAW0" + u.astype(np.uint16).tobytes()
    np.testing.assert_array_equal(rice.rice_decode(raw, codes.size, dtype), codes)
    assert not rice.rice_encode(codes).startswith((b"RAW0", b"RAW1"))


def test_wrong_dtypes_raise():
    for bad in (np.zeros(4, np.uint8), np.zeros(4, np.float32), np.zeros(4, np.int64)):
        with pytest.raises(TypeError):
            rice.rice_encode(bad)
        with pytest.raises(TypeError):
            rice.rc_encode(bad.reshape(2, 2))
    with pytest.raises(ValueError):
        rice.rc_encode(np.zeros((1, 2, 2, 2), np.int8))


def test_a_library_that_cannot_build_raises_with_its_command(tmp_path, monkeypatch):
    with pytest.raises(RuntimeError, match="no-such-compiler"):
        rice.build(cxx="no-such-compiler", root=tmp_path)
    monkeypatch.setattr(rice, "_lib", None)
    monkeypatch.setattr(rice, "CXX", "no-such-compiler")
    monkeypatch.setattr(rice, "BUILD_ROOT", tmp_path)
    for call in (lambda: rice.rice_encode(I8), lambda: rice.rc_encode(I8),
                 lambda: rice.rc_decode(bytes.fromhex(GOLDEN[("rc", "i8")]), I8.shape, np.int8)):
        with pytest.raises(RuntimeError, match="no-such-compiler -std=c\\+\\+17"):
            call()
