"""Flax's msgpack weight files, read and written without flax and without
the ``msgpack`` package.

The JAX package keeps a model's weights as ``<name>.msgpack``, the bytes of
``flax.serialization.to_bytes(variables)`` (``wicca_tpu/models/registry.py``
reads them; ``wicca_tpu/models/convert.py`` and ``tools/convert_weights.py``
write them, and so does the port's ``models/convert.convert_h5`` through
:func:`write`). That format is a msgpack document (the msgpack C packer's
choices: the smallest int, str, bin, map and array headers, floats as
float64, ``fixext`` where a payload is 1, 2, 4, 8 or 16 bytes long) of
nested maps with str keys whose leaves are flax's extension types:

* ext 1, an ndarray: the packed tuple ``(shape, dtype name, C-order bytes)``;
* ext 2, a Python complex: the packed tuple ``(real, imag)``;
* ext 3, a numpy scalar: an ndarray of shape ``()``;
* an array of more than :data:`MAX_CHUNK_SIZE` bytes as the map
  ``{'__msgpack_chunked_array__': True, 'shape': {'0': ...}, 'chunks':
  {'0': <flat ndarray>, ...}}``.

:func:`read` restores a document as flax's ``msgpack_restore`` does, with
numpy arrays; a ``bfloat16`` leaf (numpy has no such type without
``ml_dtypes``) comes back exactly, as a ``torch.bfloat16`` tensor.
:func:`write` gives the bytes ``flax.serialization.to_bytes`` gives for the
same tree; its leaves may also be torch tensors (``bfloat16`` included).
"""

from __future__ import annotations

import struct

import numpy as np
import torch

# flax.serialization.MAX_CHUNK_SIZE: arrays above it are written in chunks
MAX_CHUNK_SIZE = 2**30
_CHUNKED = "__msgpack_chunked_array__"
_NDARRAY, _COMPLEX, _NPSCALAR = 1, 2, 3


class _BF16:
    """A bfloat16 array held as its uint16 bit patterns."""

    def __init__(self, bits: np.ndarray):
        self.bits = bits

    def tensor(self) -> torch.Tensor:
        return torch.from_numpy(np.array(self.bits, dtype=np.uint16).view(np.int16)).view(torch.bfloat16)


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------


def _head(out: list, n: int, fix: int | None, fixmax: int, c8: int | None, c16: int, c32: int) -> None:
    if fix is not None and n <= fixmax:
        out.append(bytes((fix | n,)))
    elif c8 is not None and n < 1 << 8:
        out.append(struct.pack(">BB", c8, n))
    elif n < 1 << 16:
        out.append(struct.pack(">BH", c16, n))
    elif n < 1 << 32:
        out.append(struct.pack(">BI", c32, n))
    else:
        raise ValueError(f"msgpack cannot hold an object of {n} entries or bytes")


def _int(out: list, v: int) -> None:
    if 0 <= v < 128 or -32 <= v < 0:
        out.append(struct.pack(">b" if v < 0 else ">B", v))
    elif v > 0:
        for code, fmt, top in ((0xCC, ">BB", 1 << 8), (0xCD, ">BH", 1 << 16), (0xCE, ">BI", 1 << 32),
                               (0xCF, ">BQ", 1 << 64)):
            if v < top:
                out.append(struct.pack(fmt, code, v))
                return
        raise OverflowError(f"{v} does not fit msgpack's uint64")
    else:
        for code, fmt, low in ((0xD0, ">Bb", -(1 << 7)), (0xD1, ">Bh", -(1 << 15)), (0xD2, ">Bi", -(1 << 31)),
                               (0xD3, ">Bq", -(1 << 63))):
            if v >= low:
                out.append(struct.pack(fmt, code, v))
                return
        raise OverflowError(f"{v} does not fit msgpack's int64")


def _bin(out: list, b: bytes) -> None:
    _head(out, len(b), None, 0, 0xC4, 0xC5, 0xC6)
    out.append(b)


def _str(out: list, s: str) -> None:
    b = s.encode("utf-8")
    _head(out, len(b), 0xA0, 31, 0xD9, 0xDA, 0xDB)
    out.append(b)


def _ext(out: list, code: int, payload: bytes) -> None:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}.get(len(payload))
    if fixed is not None:
        out.append(struct.pack(">Bb", fixed, code))
    else:
        _head(out, len(payload), None, 0, 0xC7, 0xC8, 0xC9)
        out.append(struct.pack(">b", code))
    out.append(payload)


def _ndarray_payload(shape, dtype_name: str, data: bytes) -> bytes:
    """``msgpack.packb((shape, dtype_name, data), use_bin_type=True)``."""
    out: list = []
    out.append(b"\x93")
    _head(out, len(shape), 0x90, 15, None, 0xDC, 0xDD)
    for d in shape:
        _int(out, int(d))
    _str(out, dtype_name)
    _bin(out, data)
    return b"".join(out)


def _leaf(x):
    """A torch tensor as the array flax would see; anything else as is."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return _BF16(x.contiguous().view(torch.int16).numpy().view(np.uint16))
        return x.numpy()
    return x


def _chunked(arr):
    """flax's ``_chunk``: the chunked-array map of an oversized array."""
    flat_ = (arr.bits if isinstance(arr, _BF16) else arr).reshape(-1)
    size = max(1, int(MAX_CHUNK_SIZE / flat_.dtype.itemsize))
    chunks = [flat_[i : i + size] for i in range(0, flat_.size, size)]
    if isinstance(arr, _BF16):
        chunks = [_BF16(c) for c in chunks]
    shape = arr.bits.shape if isinstance(arr, _BF16) else arr.shape
    return {_CHUNKED: True, "shape": {str(i): d for i, d in enumerate(shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _state(x):
    """flax's ``to_state_dict`` and chunking of a tree of dicts, lists and
    tuples: containers become str-keyed dicts, oversized arrays chunk maps."""
    if isinstance(x, dict):
        keys = [str(k) for k in x]
        if len(set(keys)) != len(keys):
            raise ValueError(f"dict keys do not have a unique string representation: {list(x)}")
        return {str(k): _state(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return {str(i): _state(v) for i, v in enumerate(x)}
    x = _leaf(x)
    if isinstance(x, (np.ndarray, _BF16)):
        a = x.bits if isinstance(x, _BF16) else x
        if a.size * a.dtype.itemsize > MAX_CHUNK_SIZE:
            return _chunked(x)
    return x


def _pack(out: list, x) -> None:
    t = type(x)
    if x is None:
        out.append(b"\xc0")
    elif t is bool:
        out.append(b"\xc3" if x else b"\xc2")
    elif t is int:
        _int(out, x)
    elif t is float:
        out.append(struct.pack(">Bd", 0xCB, x))
    elif t is str:
        _str(out, x)
    elif t in (bytes, bytearray):
        _bin(out, bytes(x))
    elif t is dict:
        _head(out, len(x), 0x80, 15, None, 0xDE, 0xDF)
        for k, v in x.items():
            _pack(out, k)
            _pack(out, v)
    elif t is _BF16:
        _ext(out, _NDARRAY, _ndarray_payload(x.bits.shape, "bfloat16", x.bits.tobytes("C")))
    elif isinstance(x, np.ndarray):
        if x.dtype.hasobject or x.dtype.isalignedstruct:
            raise ValueError("Object and structured dtypes not supported for serialization of ndarrays.")
        _ext(out, _NDARRAY, _ndarray_payload(x.shape, x.dtype.name, x.tobytes("C")))
    elif isinstance(x, np.generic):
        a = np.asarray(x)
        _ext(out, _NPSCALAR, _ndarray_payload(a.shape, a.dtype.name, a.tobytes("C")))
    elif t is complex:
        _ext(out, _COMPLEX, struct.pack(">BBdBd", 0x92, 0xCB, x.real, 0xCB, x.imag))
    else:
        raise TypeError(f"can not serialize {t.__name__!r} object")


def write(tree) -> bytes:
    """The bytes of ``flax.serialization.to_bytes(tree)`` for a tree of
    dicts, lists and tuples whose leaves are numpy arrays and scalars, torch
    tensors, Python scalars, str, bytes or None."""
    out: list = []
    _pack(out, _state(tree))
    return b"".join(out)


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------


class _Reader:
    def __init__(self, data):
        self.buf = memoryview(data).cast("B")
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError(f"msgpack data ends inside an object at byte {self.pos}")
        b = self.buf[self.pos : self.pos + n]
        self.pos += n
        return b

    def unpack(self, fmt: str):
        size = struct.calcsize(fmt)
        (v,) = struct.unpack_from(fmt, self.take(size))
        return v

    def obj(self):
        c = self.unpack(">B")
        if c <= 0x7F:
            return c
        if c >= 0xE0:
            return c - 0x100
        if 0x80 <= c <= 0x8F:
            return self.map(c & 0x0F)
        if 0x90 <= c <= 0x9F:
            return [self.obj() for _ in range(c & 0x0F)]
        if 0xA0 <= c <= 0xBF:
            return str(self.take(c & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if c in simple:
            return simple[c]
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if c in sized:
            b = self.take(self.unpack(sized[c]))
            return bytes(b) if c <= 0xC6 else str(b, "utf-8")
        if c in (0xC7, 0xC8, 0xC9):
            n = self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[c])
            return self.ext(self.unpack(">b"), self.take(n))
        if 0xD4 <= c <= 0xD8:
            code = self.unpack(">b")
            return self.ext(code, self.take(1 << (c - 0xD4)))
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q", 0xD0: ">b",
                   0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if c in numbers:
            return self.unpack(numbers[c])
        if c in (0xDC, 0xDD):
            return [self.obj() for _ in range(self.unpack(">H" if c == 0xDC else ">I"))]
        if c in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if c == 0xDE else ">I"))
        raise ValueError(f"byte 0x{c:02x} at {self.pos - 1} starts no msgpack object")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out

    def ext(self, code: int, payload: memoryview):
        if code == _COMPLEX:
            re_, im = _Reader(payload).obj()
            return complex(re_, im)
        if code not in (_NDARRAY, _NPSCALAR):
            raise ValueError(f"msgpack extension type {code} is none of flax's")
        shape, name, raw = _Reader(payload).array_parts()
        if name == "bfloat16":
            arr = _BF16(np.frombuffer(raw, dtype=np.uint16).reshape(shape))
        else:
            arr = np.frombuffer(raw, dtype=np.dtype(name)).reshape(shape)
        if code == _NPSCALAR:
            return arr.tensor().reshape(()) if isinstance(arr, _BF16) else arr[()]
        return arr

    def array_parts(self):
        """``(shape, dtype name, data)`` of an ndarray payload, the data as
        a view of the document (no copy)."""
        if self.unpack(">B") != 0x93:
            raise ValueError("an ndarray payload is not a 3-tuple")
        shape = tuple(self.obj())
        name = self.obj()
        c = self.unpack(">B")
        if c not in (0xC4, 0xC5, 0xC6):
            raise ValueError("an ndarray payload holds no bin data")
        raw = self.take(self.unpack({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[c]))
        return shape, name, raw


def _restore(x):
    """flax's ``_unchunk_array_leaves_in_place``; bfloat16 arrays as torch
    tensors."""
    if isinstance(x, _BF16):
        return x.tensor()
    if not isinstance(x, dict):
        return x
    if _CHUNKED in x:
        shape = tuple(x["shape"][str(i)] for i in range(len(x["shape"])))
        chunks = [x["chunks"][str(i)] for i in range(len(x["chunks"]))]
        if chunks and isinstance(chunks[0], _BF16):
            return _BF16(np.concatenate([c.bits for c in chunks]).reshape(shape)).tensor()
        return np.concatenate(chunks).reshape(shape)
    return {k: _restore(v) for k, v in x.items()}


def read(data) -> dict:
    """The tree of a flax msgpack document (``bytes`` or any buffer), as
    ``flax.serialization.msgpack_restore`` gives it: nested dicts with numpy
    leaves (read-only views of ``data``), chunked arrays joined, and each
    ``bfloat16`` leaf a ``torch.bfloat16`` tensor with its exact bits."""
    r = _Reader(data)
    tree = r.obj()
    if r.pos != len(r.buf):
        raise ValueError(f"{len(r.buf) - r.pos} bytes follow the msgpack document")
    return _restore(tree)
