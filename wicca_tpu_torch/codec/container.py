"""The ``.wct`` container ("wicca-tpu codestream"), counterpart of
``wicca_tpu/codec/container.py``: the same bytes for the same stream, and
each package reads the other's files.

Layout (little-endian):
  magic b'WCT4' | u8 wavelet | u8 levels | u8 lead(channels) | u32 orig_h | u32 orig_w |
  f32 base_step | f32 level_gain | u32 ll_h | u32 ll_w |
  u8 color (0 none / 1 rct / 2 ict) | f32 chroma_gain |
  u8 layout (0 global / 1 tiled) |
  raw LL plane (float32; int32 for the integer wavelets) |
  per level (fine->coarse), per band (lh, hl, hh):
    u8 codec (0 rice, 1 rc) | u8 dtype_code (0 int8, 1 int16, 2 int32) |
    u32 sub_h | u32 sub_w | u32 nbytes | entropy bitstream

Variants, picked from the stream as the reference picks them:
  WCT5  quality layers (``quality_layers`` > 1): u8 n_layers after the
        layout byte, a plane directory (u8 dtype | u32 sub_h | u32 sub_w),
        then per layer, per plane: u8 codec | u32 nbytes | bitstream. Layer 0
        holds the codes shifted right (sign-magnitude) by n_layers-1 bits,
        exactly the codes of the same encode at ``base_step * 2**(n-1)``;
        each later layer the ternary refinement ``c_k - 2 c_{k-1}``.
  WCT6  bit_depth != 8 or an ROI stream: u8 bit_depth | u8 n_layers |
        u8 roi_shift | u8 bg_shift after the layout byte.
  WCT7  ``hh_gain`` != 1: WCT6's block + f32 hh_gain.
  WCT8  application metadata: the full block, then u16 n_items | per item
        (u16 keylen | key utf-8 | u32 vallen | value), before the LL.
  WCT9  R-D divisors (``band_div``): the full block, u8 per detail plane,
        then the metadata block (n_items may be 0).
  WC10  a coded LL (``ll_codec``): all of the above, then u8 ll_mode
        (1 Rice of the int32 LL, 2 midtread-quantized at f32 ll_step, then
        Rice) | f32 ll_step | u32 nbytes | blob in place of the raw LL.
  Readable besides: WCT3 (no per-plane codec byte: all Rice), WCT2 (no
  layout byte: wide streams tiled) and WCT1 (no color fields; db2, bior4.4
  and cdf97 streams of that era are whole-image lifting, layout 'global').

Integrity trailer (``checksums=True``): b'WCTS' | u8 ver(1) | u32 n_units |
per unit (u64 end_offset, u32 crc32) | u32 self_crc. Unit 0 is the header,
LL and plane directory; each plane section is a unit of its own, so
``deserialize(..., on_error='zero')`` drops a corrupt band and decodes the
rest.

The entropy stage (:mod:`wicca_tpu_torch.native.rice`) runs plane-parallel
on host threads. ``serialize`` takes a stream wherever its tensors lie and
copies them to the host once; ``deserialize``/``load`` build the planes on
the host and move each once to ``device`` (CUDA unless the caller passes
``device='cpu'``: container bytes are host data). Unlike the reference, a
missing entropy library raises (naming the compiler command) instead of
writing numpy ``RAW0``/``RAW1`` planes, which would change the bytes; such
planes written by the reference are read.
"""

from __future__ import annotations

import concurrent.futures
import logging
import os
import struct
import zlib

import numpy as np
import torch

from wicca_tpu_torch._device import host_data_device
from wicca_tpu_torch.codec.pipeline import CodeStream
from wicca_tpu_torch.comm import gather_stream
from wicca_tpu_torch.core.quant import QuantSpec
from wicca_tpu_torch.native.rice import native_available, rc_decode, rc_encode, rice_decode, rice_encode  # noqa: F401

_MAGIC, _MAGIC_V5, _MAGIC_V6, _MAGIC_V7 = b"WCT4", b"WCT5", b"WCT6", b"WCT7"
_MAGIC_V8, _MAGIC_V9, _MAGIC_V10 = b"WCT8", b"WCT9", b"WC10"
_ALL_MAGICS = (b"WCT1", b"WCT2", b"WCT3", b"WCT4", b"WCT5", b"WCT6", b"WCT7", b"WCT8", b"WCT9", b"WC10")
_VERSIONS = {m: i + 1 for i, m in enumerate(_ALL_MAGICS)}
_COLORS = {"none": 0, "rct": 1, "ict": 2}
_COLORS_INV = {v: k for k, v in _COLORS.items()}
_LAYOUTS = {"global": 0, "tiled": 1}
_LAYOUTS_INV = {v: k for k, v in _LAYOUTS.items()}
# WCT1-era db2, bior4.4 and cdf97 streams were whole-image lifting
_V1_GLOBAL_WAVELET_IDS = {1, 2, 3}
_DTYPES = {np.dtype(np.int8): 0, np.dtype(np.int16): 1, np.dtype(np.int32): 2}
_DTYPES_INV = {0: np.int8, 1: np.int16, 2: np.int32}
_WAVELETS = {"haar": 0, "db2": 1, "bior4.4": 2, "cdf97": 3, "haar_int": 4, "legall5.3": 5, "cdf53": 5}
_WAVELETS_INV = {0: "haar", 1: "db2", 2: "bior4.4", 3: "cdf97", 4: "haar_int", 5: "legall5.3"}
_INT_WAVELET_IDS = {4, 5}  # integer streams carry an int32 LL (same 4-byte stride)
_CODEC_RICE, _CODEC_RC = 0, 1
_TRAILER_MAGIC = b"WCTS"
_TRAILER_VER = 1
# codec='auto' keeps rc only when its stream is at least this much smaller
# than rice's (rc decodes 5-6x slower); planes of _PROBE_MIN_BYTES or more
# first code two contiguous row bands, and skip the full rc pass when the
# probed win is under _RC_MIN_WIN - _PROBE_MARGIN. The reference's values:
# a different threshold or probe picks another codec for some plane.
_RC_MIN_WIN = 0.05
_PROBE_MIN_BYTES = 1 << 21
_PROBE_MARGIN = 0.02


def _as_bytes(data, limit: int | None = None) -> bytes:
    """``data`` itself, or the first ``limit`` bytes (all: None) of the file
    it names."""
    if isinstance(data, (bytes, bytearray, memoryview)):
        return bytes(data)
    with open(data, "rb") as f:
        return f.read() if limit is None else f.read(limit)


def peek_layers(data) -> int:
    """Quality-layer count recorded in a container header (1 for flat
    streams). Accepts bytes or a file path; reads only the header."""
    data = _as_bytes(data, 64)
    if data[:4] not in _ALL_MAGICS:
        raise ValueError("not a WCT container")
    version = _VERSIONS[data[:4]]
    if version < 5:
        return 1
    off = 4 + struct.calcsize("<BBBIIffII") + struct.calcsize("<Bf") + 1
    if version == 5:
        return struct.unpack_from("<B", data, off)[0]
    return struct.unpack_from("<BBBB", data, off)[1]  # WCT6+: bit_depth, n_layers, ...


def _trailer_bytes(unit_ends: list[tuple[int, int]]) -> bytes:
    t = bytearray(_TRAILER_MAGIC)
    t += struct.pack("<BI", _TRAILER_VER, len(unit_ends))
    for end, crc in unit_ends:
        t += struct.pack("<QI", end, crc)
    t += struct.pack("<I", zlib.crc32(bytes(t)))
    return bytes(t)


def _read_trailer(data: bytes, n_units: int) -> list[tuple[int, int]] | None:
    """The trailer's (end_offset, crc) per unit; None when absent or
    unreadable (a damaged trailer reads as no trailer)."""
    size = 4 + 5 + 12 * n_units + 4
    if len(data) < size:
        return None
    t = data[len(data) - size :]
    if t[:4] != _TRAILER_MAGIC:
        return None
    if struct.unpack_from("<I", t, size - 4)[0] != zlib.crc32(t[: size - 4]):
        return None
    ver, n = struct.unpack_from("<BI", t, 4)
    if ver != _TRAILER_VER or n != n_units:
        return None
    return [struct.unpack_from("<QI", t, 9 + 12 * i) for i in range(n)]


def _scan_trailer_units(data: bytes) -> int | None:
    """Unit count of a valid trailer at EOF, found without the header (a
    corrupt levels or n_layers byte then disagrees with it)."""
    for n in range(4096):
        size = 13 + 12 * n
        if size > len(data):
            return None
        pos = len(data) - size
        if data[pos : pos + 4] == _TRAILER_MAGIC and _read_trailer(data, n) is not None:
            return n
    return None


def _encode_plane(plane: np.ndarray, codec: str) -> tuple[int, bytes]:
    """Entropy-code one detail plane -> (codec_id, blob) per the policy."""
    if codec == "rice":
        return _CODEC_RICE, rice_encode(plane)
    if codec == "rc":
        return _CODEC_RC, rc_encode(plane)
    rice_blob = rice_encode(plane)
    if plane.nbytes >= _PROBE_MIN_BYTES:
        # contiguous row bands at 1/4 and 3/4 height (strided rows would
        # break the vertical context rc exploits)
        h = plane.shape[-2]
        band = max(1, h // 16)
        rows = [
            plane[..., max(0, h // 4 - band // 2) : h // 4 + (band + 1) // 2, :],
            plane[..., max(0, 3 * h // 4 - band // 2) : 3 * h // 4 + (band + 1) // 2, :],
        ]
        probe = np.ascontiguousarray(np.concatenate(rows, axis=-2))
        win = 1.0 - len(rc_encode(probe)) / max(len(rice_encode(probe)), 1)
        if win < _RC_MIN_WIN - _PROBE_MARGIN:
            return _CODEC_RICE, rice_blob
    rc_blob = rc_encode(plane)
    if len(rc_blob) < (1.0 - _RC_MIN_WIN) * len(rice_blob):
        return _CODEC_RC, rc_blob
    return _CODEC_RICE, rice_blob


def _split_layers(plane: np.ndarray, n_layers: int) -> list[np.ndarray]:
    """Codes -> [c0 (plane dtype), r_1..r_{L-1} ternary int8] by the
    sign-magnitude bit-plane split c_k = sign(c) * (|c| >> (L-1-k)). numpy
    on the host: the shifts are of magnitudes, never of negative ints."""
    mag = np.abs(plane.astype(np.int32))
    sg = np.sign(plane).astype(np.int32)
    prev = sg * (mag >> (n_layers - 1))
    subs = [prev.astype(plane.dtype)]
    for k in range(1, n_layers):
        cur = sg * (mag >> (n_layers - 1 - k))
        subs.append((cur - 2 * prev).astype(np.int8))
        prev = cur
    return subs


def _join_layers(subs: list[np.ndarray], dtype) -> np.ndarray:
    """Inverse of :func:`_split_layers` over any layer prefix."""
    c = subs[0].astype(np.int32)
    for r in subs[1:]:
        c = 2 * c + r
    return c.astype(dtype)


def _widen_codes(plane: np.ndarray, missing: int, dtype) -> np.ndarray:
    """Codes of a stream truncated ``missing`` layers early, widened to the
    bin midpoints: sign(c) * ((|c| << m) + 2**(m-1)), 0 stays 0."""
    if missing == 0:
        return plane.astype(dtype)
    mag = np.abs(plane.astype(np.int32))
    sg = np.sign(plane).astype(np.int32)
    return (sg * ((mag << missing) + (1 << (missing - 1)))).astype(dtype)


def host_arrays(tensors) -> list[np.ndarray]:
    """Each tensor as a numpy array on the host: CUDA tensors are copied
    into pinned memory without waiting and the card is synchronized once;
    CPU tensors and numpy arrays are used as they are."""
    out, cuda = [], False
    for t in tensors:
        if isinstance(t, torch.Tensor) and t.device.type == "cuda":
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            out.append(h)
            cuda = True
        else:
            out.append(t)
    if cuda:
        torch.cuda.synchronize()
    return [a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a) for a in out]


def _to_device(arrays: list[np.ndarray], device) -> list[torch.Tensor]:
    """Host arrays as tensors on ``device``: each moved once from pinned
    memory without waiting, then one synchronization."""
    dev = host_data_device(device)
    if dev.type != "cuda":
        return [torch.from_numpy(a).to(dev) for a in arrays]
    out = [torch.from_numpy(a).pin_memory().to(dev, non_blocking=True) for a in arrays]
    torch.cuda.synchronize(dev)
    return out


def serialize(
    stream: CodeStream,
    threads: int = 8,
    codec: str = "auto",
    quality_layers: int = 1,
    checksums: bool = True,
    ll_codec: str = "raw",
    ll_step: float = 0.125,
) -> bytes:
    """CodeStream -> container bytes (detail planes entropy-coded in
    parallel on ``threads`` host threads).

    ``codec``: 'auto' (per plane, rc only when it is at least 5% smaller),
    'rice' (fastest) or 'rc' (context-modeled range coder).
    ``quality_layers`` > 1 writes the SNR-layered variant; ``checksums``
    appends the integrity trailer; ``ll_codec`` 'rice' (integer LL,
    lossless) or 'quant' (float LL at ``ll_step``) codes the LL (WC10),
    'raw' keeps the <= WCT9 layout. A mesh stream is gathered first
    (:func:`~wicca_tpu_torch.comm.gather_stream`)."""
    stream = gather_stream(stream)
    if codec not in ("auto", "rice", "rc"):
        raise ValueError(f"codec must be auto|rice|rc, got {codec!r}")
    if not 1 <= quality_layers <= 15:
        raise ValueError("quality_layers must be in [1, 15]")
    if ll_codec not in ("raw", "rice", "quant"):
        raise ValueError(f"ll_codec must be raw|rice|quant, got {ll_codec!r}")
    ll_dtype = np.int32 if _WAVELETS[stream.wavelet] in _INT_WAVELET_IDS else np.float32
    if ll_codec == "rice" and ll_dtype != np.int32:
        raise ValueError("ll_codec='rice' is lossless for INTEGER LL planes; use 'quant' for float LL")
    if ll_codec == "quant" and ll_dtype != np.float32:
        raise ValueError("ll_codec='quant' quantizes FLOAT LL planes; integer LL is lossless with 'rice'")
    if ll_codec == "quant" and not ll_step > 0:
        raise ValueError("ll_step must be positive")
    ll, *planes = host_arrays([stream.ll] + [b for bands in stream.details for b in bands])
    ll = ll.astype(ll_dtype, copy=False)
    lead = ll.shape[0] if ll.ndim == 3 else 1
    if lead > 0xFF or stream.levels > 0xFF:
        raise ValueError(f"the container holds at most 255 planes and 255 levels, got {lead} and {stream.levels}"
                         " (flatten leading batch dimensions into several files)")
    out = bytearray()
    bit_depth, roi_shift, bg_shift = stream.bit_depth, stream.roi_shift, stream.bg_shift
    hh_gain = stream.spec.hh_gain
    meta = tuple(stream.metadata or ())
    band_div = tuple(stream.band_div or ())
    v10 = ll_codec != "raw"
    v9 = any(d != 1 for d in band_div) and not v10
    v8 = bool(meta) and not v9 and not v10
    v7 = hh_gain != 1.0 and not v8 and not v9 and not v10
    v6 = (bit_depth != 8 or roi_shift > 0) and not v7 and not v8 and not v9 and not v10
    extended = v6 or v7 or v8 or v9 or v10
    if v10:
        out += _MAGIC_V10
    elif v9:
        out += _MAGIC_V9
    elif v8:
        out += _MAGIC_V8
    elif v7:
        out += _MAGIC_V7
    elif v6:
        out += _MAGIC_V6
    else:
        out += _MAGIC_V5 if quality_layers > 1 else _MAGIC
    out += struct.pack("<BBBIIffII", _WAVELETS[stream.wavelet], stream.levels, lead, stream.orig_shape[0],
                       stream.orig_shape[1], stream.spec.base_step, stream.spec.level_gain, ll.shape[-2],
                       ll.shape[-1])
    out += struct.pack("<Bf", _COLORS[stream.color], stream.chroma_gain)
    out += struct.pack("<B", _LAYOUTS[stream.layout])
    if extended:
        out += struct.pack("<BBBB", bit_depth, quality_layers, roi_shift, bg_shift)
    if v7 or v8 or v9 or v10:
        out += struct.pack("<f", hh_gain)
    if v9 or v10:
        divs = band_div + (1,) * (stream.levels * 3 - len(band_div))
        if len(divs) != stream.levels * 3 or any(not 1 <= d <= 255 for d in divs):
            raise ValueError(f"band_div must hold levels*3 divisors in [1, 255], got {band_div}")
        out += bytes(divs)
    if v8 or v9 or v10:
        if len(meta) > 0xFFFF:
            raise ValueError("too many metadata items (max 65535)")
        out += struct.pack("<H", len(meta))
        for key, val in meta:
            kb = key.encode("utf-8")
            if len(kb) > 0xFFFF:
                raise ValueError(f"metadata key too long: {key[:40]!r}...")
            if len(val) > 0xFFFFFFFF:
                raise ValueError(f"metadata value for {key!r} exceeds 4 GiB")
            out += struct.pack("<H", len(kb)) + kb
            out += struct.pack("<I", len(val)) + val
    units: list[tuple[int, int]] = []  # (end_offset, crc32) per unit

    def close_unit(start: int) -> None:
        units.append((len(out), zlib.crc32(bytes(out[start:]))))

    def ll_section() -> bytes:
        if not v10:
            return ll.tobytes()
        if ll_codec == "rice":
            blob, mode, step = rice_encode(ll.astype(np.int32)), 1, 0.0
        else:
            blob, mode, step = rice_encode(np.round(ll / ll_step).astype(np.int32)), 2, ll_step
        return struct.pack("<BfI", mode, step, len(blob)) + blob

    def code_all(items):
        with concurrent.futures.ThreadPoolExecutor(max_workers=threads) as pool:
            return list(pool.map(lambda p: _encode_plane(p, codec), items))

    if quality_layers == 1:
        encoded = code_all(planes)
        out += ll_section()
        close_unit(0)
        for plane, (codec_id, data) in zip(planes, encoded):
            start = len(out)
            out += struct.pack("<BBIII", codec_id, _DTYPES[plane.dtype], plane.shape[-2], plane.shape[-1], len(data))
            out += data
            close_unit(start)
    else:
        # layer-major sections: a byte prefix of complete layers decodes
        if not extended:
            out += struct.pack("<B", quality_layers)
        out += ll_section()
        subs = [_split_layers(p, quality_layers) for p in planes]
        encoded = code_all([subs[i][q] for q in range(quality_layers) for i in range(len(planes))])
        for plane in planes:
            out += struct.pack("<BII", _DTYPES[plane.dtype], plane.shape[-2], plane.shape[-1])
        close_unit(0)
        for codec_id, data in encoded:
            start = len(out)
            out += struct.pack("<BI", codec_id, len(data))
            out += data
            close_unit(start)
    if checksums:
        out += _trailer_bytes(units)
    return bytes(out)


def _read_metadata(data: bytes, off: int, version: int) -> tuple[tuple, int]:
    """The WCT8 metadata block at ``off`` -> ((key, value), ...), new offset;
    a malformed block raises ValueError."""
    if version < 8:
        return (), off
    try:
        (n_items,) = struct.unpack_from("<H", data, off)
        off += 2
        items = []
        for _ in range(n_items):
            (klen,) = struct.unpack_from("<H", data, off)
            off += 2
            key = data[off : off + klen].decode("utf-8")
            off += klen
            (vlen,) = struct.unpack_from("<I", data, off)
            off += 4
            if off + vlen > len(data):
                raise ValueError("metadata value overruns the container")
            items.append((key, bytes(data[off : off + vlen])))
            off += vlen
    except (struct.error, UnicodeDecodeError) as e:
        raise ValueError(f"container metadata block corrupt: {e}") from None
    return tuple(items), off


def _read_header(data: bytes) -> tuple[dict, int]:
    """The header fields through the extended block and the divisor table
    (not the metadata) and the offset after them."""
    if data[:4] not in _ALL_MAGICS:
        raise ValueError("not a WCT container")
    version = _VERSIONS[data[:4]]
    off = 4
    wv, levels, lead, oh, ow, base_step, level_gain, llh, llw = struct.unpack_from("<BBBIIffII", data, off)
    off += struct.calcsize("<BBBIIffII")
    color, chroma_gain = 0, 1.0
    if version > 1:
        color, chroma_gain = struct.unpack_from("<Bf", data, off)
        off += struct.calcsize("<Bf")
    if version >= 3:
        layout = _LAYOUTS_INV[struct.unpack_from("<B", data, off)[0]]
        off += 1
    else:
        layout = "global" if version == 1 and wv in _V1_GLOBAL_WAVELET_IDS else "tiled"
    n_layers, bit_depth, roi_shift, bg_shift, hh_gain = 1, 8, 0, 0, 1.0
    if version == 5:
        (n_layers,) = struct.unpack_from("<B", data, off)
        off += 1
    elif version >= 6:
        bit_depth, n_layers, roi_shift, bg_shift = struct.unpack_from("<BBBB", data, off)
        off += 4
    if version >= 7:
        (hh_gain,) = struct.unpack_from("<f", data, off)
        off += 4
    band_div: tuple[int, ...] = ()
    if version >= 9:
        band_div = tuple(data[off : off + levels * 3])
        off += levels * 3
    head = dict(version=version, wv=wv, levels=levels, lead=lead, orig_shape=(oh, ow), base_step=base_step,
                level_gain=level_gain, ll_shape=(llh, llw), color=color, chroma_gain=chroma_gain, layout=layout,
                n_layers=n_layers, bit_depth=bit_depth, roi_shift=roi_shift, bg_shift=bg_shift, hh_gain=hh_gain,
                band_div=band_div, layered=version == 5 or (version >= 6 and n_layers > 1))
    return head, off


def _raise_or_warn(corrupt: list[str], on_error: str) -> None:
    if not corrupt:
        return
    if on_error == "raise":
        raise ValueError(f"container corrupt in {len(corrupt)} section(s): {', '.join(corrupt)}"
                         " (pass on_error='zero' to decode around them)")
    logging.warning(f"decoding around {len(corrupt)} corrupt section(s): {', '.join(corrupt)}")


def deserialize(
    data: bytes,
    threads: int = 8,
    max_layers: int | None = None,
    allow_truncated: bool = False,
    on_error: str = "raise",
    device=None,
) -> CodeStream:
    """Container bytes -> CodeStream on ``device`` (CUDA unless the caller
    passes ``device='cpu'``), planes entropy-decoded in parallel on host
    threads.

    Layered containers: ``max_layers`` decodes that many layers (the stream
    of the coarser step); ``allow_truncated`` accepts a byte prefix and
    decodes the complete layers it holds. With a trailer every section is
    CRC-checked first: ``on_error='raise'`` raises naming the corrupt
    sections, ``'zero'`` zeroes those detail planes (a layered plane keeps
    its intact layer prefix); a corrupt header/LL section always raises."""
    if on_error not in ("raise", "zero"):
        raise ValueError(f"on_error must be raise|zero, got {on_error!r}")
    data = bytes(data)
    h, off = _read_header(data)
    version, wv, levels, lead = h["version"], h["wv"], h["levels"], h["lead"]
    llh, llw = h["ll_shape"]
    n_layers, roi_shift, bg_shift, base_step = h["n_layers"], h["roi_shift"], h["bg_shift"], h["base_step"]
    band_div = h["band_div"]
    if version >= 9:
        if len(band_div) != levels * 3 or any(d < 1 for d in band_div):
            raise ValueError("container divisor table corrupt")
        band_div = band_div if any(d != 1 for d in band_div) else ()
    metadata, off = _read_metadata(data, off, version)
    layered = h["layered"]
    ll_dtype = np.int32 if wv in _INT_WAVELET_IDS else np.float32
    if version >= 10:
        ll_mode, ll_step, ll_nbytes = struct.unpack_from("<BfI", data, off)
        off += struct.calcsize("<BfI")
        if ll_mode not in (1, 2):
            raise ValueError(f"unknown LL coding mode {ll_mode}")
        codes = rice_decode(data[off : off + ll_nbytes], lead * llh * llw, np.int32).reshape(lead, llh, llw)
        ll = (codes if ll_mode == 1 else codes.astype(np.float32) * ll_step).astype(ll_dtype)
        off += ll_nbytes
    else:
        ll = np.frombuffer(data, dtype=ll_dtype, count=lead * llh * llw, offset=off).reshape(lead, llh, llw).copy()
        off += ll.nbytes
    n_planes = levels * 3
    n_units = 1 + n_planes * (n_layers if layered else 1)
    trailer = _read_trailer(data, n_units)
    if trailer is None:
        scanned = _scan_trailer_units(data)
        if scanned is not None and scanned != n_units:
            raise ValueError(f"container header corrupt: trailer records {scanned} sections,"
                             f" header implies {n_units}")
    corrupt: list[str] = []

    def dec(args):
        meta, blob = args
        if meta is None or blob is None:
            return None  # corrupt section: zeroed below
        codec_id, dt_code, sh, sw = meta
        dtype = _DTYPES_INV[dt_code]
        if codec_id == _CODEC_RC:
            return rc_decode(blob, (lead, sh, sw), dtype)
        return rice_decode(blob, lead * sh * sw, dtype).reshape(lead, sh, sw)

    def decode_all(metas, blobs):
        with concurrent.futures.ThreadPoolExecutor(max_workers=threads) as pool:
            return list(pool.map(dec, zip(metas, blobs)))

    if layered:
        dirs = []
        for _ in range(n_planes):
            dirs.append(struct.unpack_from("<BII", data, off))
            off += struct.calcsize("<BII")
        want = n_layers if max_layers is None else max(1, min(max_layers, n_layers))
        metas, blobs, have = [], [], 0
        if trailer is not None:
            if trailer[0][0] != off or zlib.crc32(data[:off]) != trailer[0][1]:
                raise ValueError("container header/LL section corrupt (checksum mismatch)")
            msz = struct.calcsize("<BI")
            have = want
            for q in range(want):
                for i in range(n_planes):
                    j = q * n_planes + i
                    sec = data[trailer[j][0] : trailer[j + 1][0]]
                    dt_code, sh, sw = dirs[i]
                    if zlib.crc32(sec) != trailer[j + 1][1] or len(sec) < msz:
                        corrupt.append(f"layer {q} plane {i}")
                        metas.append(None)
                        blobs.append(None)
                        continue
                    codec_id, nbytes = struct.unpack_from("<BI", sec, 0)
                    metas.append((codec_id, dt_code if q == 0 else 0, sh, sw))
                    blobs.append(sec[msz : msz + nbytes])
            _raise_or_warn(corrupt, on_error)
        else:
            for q in range(want):
                layer_metas, layer_blobs = [], []
                try:
                    for i in range(n_planes):
                        codec_id, nbytes = struct.unpack_from("<BI", data, off)
                        off += struct.calcsize("<BI")
                        # a truncated checksummed file may leave trailer
                        # fragments after the last whole layer
                        if codec_id > _CODEC_RC or off + nbytes > len(data):
                            raise struct.error("truncated blob")
                        dt_code, sh, sw = dirs[i]
                        layer_metas.append((codec_id, dt_code if q == 0 else 0, sh, sw))
                        layer_blobs.append(data[off : off + nbytes])
                        off += nbytes
                except struct.error:
                    if allow_truncated and have >= 1:
                        break
                    raise ValueError(f"truncated layered container: {have}/{want} complete layers"
                                     " (pass allow_truncated=True to decode the prefix)") from None
                metas.extend(layer_metas)
                blobs.extend(layer_blobs)
                have += 1
        subs = decode_all(metas, blobs)
        missing = n_layers - have
        if roi_shift and missing >= roi_shift:
            raise ValueError(f"ROI stream truncated beyond its {roi_shift} guard bits ({missing} layers missing) —"
                             " ROI/background codes are no longer separable by magnitude")
        planes = []
        for i, (dt_code, sh, sw) in enumerate(dirs):
            dtype = _DTYPES_INV[dt_code]
            # a corrupt layer invalidates the plane's later refinements too
            plane_subs = []
            for q in range(have):
                s = subs[q * n_planes + i]
                if s is None:
                    break
                plane_subs.append(s)
            miss_i = n_layers - len(plane_subs)
            if not plane_subs or (roi_shift and miss_i > missing):
                # fully corrupt, or a partly corrupt ROI plane (its prefix is
                # incoherent under the global maxshift threshold): zero band
                planes.append(np.zeros((lead, sh, sw), dtype=dtype))
                continue
            c = _join_layers(plane_subs, dtype)
            if roi_shift:
                pass  # truncation folds into the roi/bg shifts below
            elif wv in _INT_WAVELET_IDS:
                c = _widen_codes(c, miss_i, dtype if miss_i == 0 else np.int32)
            elif miss_i > missing:
                # the plane lost more layers than the global truncation:
                # midpoint-widen to the global scale, saturating
                info = np.iinfo(dtype)
                c = np.clip(_widen_codes(c, miss_i - missing, np.int64), info.min, info.max).astype(dtype)
            planes.append(c)
        if missing:
            if roi_shift:
                # ROI codes spent `missing` guard bits, the background lost
                # `missing` real bits; base_step stays
                roi_shift -= missing
                bg_shift += missing
            elif wv not in _INT_WAVELET_IDS:
                base_step = base_step * float(1 << missing)  # a layer prefix is the coarser-step encode
    else:
        metas, blobs = [], []
        if trailer is not None:
            if trailer[0][0] != off or zlib.crc32(data[:off]) != trailer[0][1]:
                raise ValueError("container header/LL section corrupt (checksum mismatch)")
            msz = struct.calcsize("<BBIII")
            for i in range(n_planes):
                sec = data[trailer[i][0] : trailer[i + 1][0]]
                if zlib.crc32(sec) != trailer[i + 1][1] or len(sec) < msz:
                    corrupt.append(f"plane {i}")
                    metas.append(None)
                    blobs.append(None)
                    continue
                codec_id, dt_code, sh, sw, nbytes = struct.unpack_from("<BBIII", sec, 0)
                metas.append((codec_id, dt_code, sh, sw))
                blobs.append(sec[msz : msz + nbytes])
            _raise_or_warn(corrupt, on_error)
            # a corrupt section loses its geometry; a level's three bands
            # share shape and dtype, so take a sibling's
            for i, m in enumerate(metas):
                if m is not None:
                    continue
                lvl0 = i - i % 3
                sib = next((metas[j] for j in range(lvl0, lvl0 + 3) if metas[j] is not None), None)
                if sib is None:
                    raise ValueError(f"all three subbands of level {i // 3 + 1} are corrupt —"
                                     " plane geometry unrecoverable")
                metas[i] = (_CODEC_RICE, sib[1], sib[2], sib[3])
                blobs[i] = None
        else:
            for _ in range(n_planes):
                if version >= 4:
                    codec_id, dt_code, sh, sw, nbytes = struct.unpack_from("<BBIII", data, off)
                    off += struct.calcsize("<BBIII")
                else:
                    dt_code, sh, sw, nbytes = struct.unpack_from("<BIII", data, off)
                    off += struct.calcsize("<BIII")
                    codec_id = _CODEC_RICE
                metas.append((codec_id, dt_code, sh, sw))
                blobs.append(data[off : off + nbytes])
                off += nbytes
        planes = decode_all(metas, blobs)
        for i, p in enumerate(planes):
            if p is None:  # corrupt section -> zero band
                _, dt_code, sh, sw = metas[i]
                planes[i] = np.zeros((lead, sh, sw), dtype=_DTYPES_INV[dt_code])
    ll, *planes = _to_device([ll] + planes, device)
    details = tuple(tuple(planes[i * 3 : i * 3 + 3]) for i in range(levels))
    spec = QuantSpec(base_step=base_step, level_gain=h["level_gain"], hh_gain=h["hh_gain"])
    return CodeStream(
        ll=ll, details=details, spec=spec, levels=levels, orig_shape=h["orig_shape"],
        wavelet=_WAVELETS_INV[wv], color=_COLORS_INV[h["color"]], chroma_gain=float(h["chroma_gain"]),
        layout=h["layout"], bit_depth=int(h["bit_depth"]), roi_shift=int(roi_shift), bg_shift=int(bg_shift),
        metadata=metadata, band_div=band_div,
    )


_BAND_NAMES = ("lh", "hl", "hh")
_CODEC_NAMES = {_CODEC_RICE: "rice", _CODEC_RC: "rc"}


def inspect(data, verify: bool = True) -> dict:
    """Structural dump of a container without entropy-decoding it: header
    fields, one entry per plane section (``level band [layer] codec dtype
    shape nbytes``), sizes, ``bpp`` and ``compression_ratio``, metadata
    sizes, and with ``verify`` the trailer's verdict (``integrity`` 'ok',
    'corrupt' or 'unverified', ``corrupt_sections``). Accepts bytes or a
    file path."""
    data = _as_bytes(data)
    h, off = _read_header(data)
    version, wv, levels, lead = h["version"], h["wv"], h["levels"], h["lead"]
    (llh, llw), (oh, ow) = h["ll_shape"], h["orig_shape"]
    n_layers, bit_depth = h["n_layers"], h["bit_depth"]
    try:
        meta_items, off = _read_metadata(data, off, version)
        meta_note = None
    except ValueError as e:
        # report the damage; the CRC audit below flags unit 0 on its own
        meta_items, meta_note = (), str(e)
        off = len(data)
    layered = h["layered"]
    ll_dtype = np.int32 if wv in _INT_WAVELET_IDS else np.float32
    ll_mode, ll_step = 0, 0.0  # 0 = raw
    if version >= 10:
        ll_mode, ll_step, ll_bytes = struct.unpack_from("<BfI", data, off)
        off += struct.calcsize("<BfI") + ll_bytes
    else:
        ll_bytes = lead * llh * llw * np.dtype(ll_dtype).itemsize
        off += ll_bytes
    n_planes = levels * 3
    n_units = 1 + n_planes * (n_layers if layered else 1)
    planes: list[dict] = []
    # counted up as layers parse: an unreadable directory reports 0
    complete_layers = 0
    entropy_bytes = 0
    try:
        if layered:
            dirs = []
            for _ in range(n_planes):
                dirs.append(struct.unpack_from("<BII", data, off))
                off += struct.calcsize("<BII")
            for q in range(n_layers):
                layer_planes = []
                for i in range(n_planes):
                    codec_id, nbytes = struct.unpack_from("<BI", data, off)
                    off += struct.calcsize("<BI")
                    if codec_id > _CODEC_RC or off + nbytes > len(data):
                        raise struct.error("truncated")
                    dt_code, sh, sw = dirs[i]
                    dt = np.int8 if q > 0 else _DTYPES_INV[dt_code]
                    layer_planes.append(dict(level=i // 3 + 1, band=_BAND_NAMES[i % 3], layer=q,
                                             codec=_CODEC_NAMES[codec_id], dtype=np.dtype(dt).name,
                                             shape=(lead, sh, sw), nbytes=nbytes))
                    off += nbytes
                planes.extend(layer_planes)
                entropy_bytes += sum(p["nbytes"] for p in layer_planes)
                complete_layers += 1
        else:
            for i in range(n_planes):
                if version >= 4:
                    codec_id, dt_code, sh, sw, nbytes = struct.unpack_from("<BBIII", data, off)
                    off += struct.calcsize("<BBIII")
                else:
                    dt_code, sh, sw, nbytes = struct.unpack_from("<BIII", data, off)
                    off += struct.calcsize("<BIII")
                    codec_id = _CODEC_RICE
                if codec_id > _CODEC_RC or off + nbytes > len(data):
                    raise struct.error("truncated")
                planes.append(dict(level=i // 3 + 1, band=_BAND_NAMES[i % 3], codec=_CODEC_NAMES[codec_id],
                                   dtype=np.dtype(_DTYPES_INV[dt_code]).name, shape=(lead, sh, sw), nbytes=nbytes))
                entropy_bytes += nbytes
                off += nbytes
            complete_layers = 1
    except struct.error:
        pass  # truncated stream: report the intact prefix
    trailer = _read_trailer(data, n_units)
    integrity, corrupt = "unverified", []
    if trailer is not None and verify:
        prev = 0
        for i, (end, crc) in enumerate(trailer):
            if zlib.crc32(data[prev:end]) != crc:
                corrupt.append("header/LL" if i == 0 else f"section {i}")
            prev = end
        integrity = "corrupt" if corrupt else "ok"
    src_bytes = oh * ow * lead * max(1, (bit_depth + 7) // 8)
    return dict(
        version=version, wavelet=_WAVELETS_INV[wv], levels=levels, channels=lead, orig_shape=(oh, ow),
        bit_depth=bit_depth, base_step=h["base_step"], level_gain=h["level_gain"], hh_gain=h["hh_gain"],
        color=_COLORS_INV[h["color"]], chroma_gain=float(h["chroma_gain"]), layout=h["layout"],
        ll_shape=(lead, llh, llw), quality_layers=n_layers, complete_layers=complete_layers,
        roi_shift=h["roi_shift"], bg_shift=h["bg_shift"], band_div=list(h["band_div"]),
        ll_mode={0: "raw", 1: "rice", 2: "quant"}.get(ll_mode, ll_mode), ll_step=ll_step,
        metadata={k: len(v) for k, v in meta_items}, metadata_error=meta_note,
        planes=planes, total_bytes=len(data), ll_bytes=ll_bytes, entropy_bytes=entropy_bytes,
        bpp=8.0 * len(data) / (oh * ow), compression_ratio=src_bytes / len(data),
        checksummed=trailer is not None, integrity=integrity, corrupt_sections=corrupt,
    )


def save(
    stream: CodeStream,
    path: str | os.PathLike,
    threads: int = 8,
    codec: str = "auto",
    quality_layers: int = 1,
    checksums: bool = True,
    ll_codec: str = "raw",
    ll_step: float = 0.125,
) -> int:
    """:func:`serialize` ``stream`` into the file ``path``; returns its size."""
    data = serialize(stream, threads, codec, quality_layers, checksums=checksums, ll_codec=ll_codec,
                     ll_step=ll_step)
    with open(path, "wb") as f:
        f.write(data)
    return len(data)


def load(
    path: str | os.PathLike,
    threads: int = 8,
    max_layers: int | None = None,
    allow_truncated: bool = False,
    on_error: str = "raise",
    device=None,
) -> CodeStream:
    """:func:`deserialize` the file ``path`` onto ``device``."""
    with open(path, "rb") as f:
        data = f.read()
    return deserialize(data, threads, max_layers=max_layers, allow_truncated=allow_truncated, on_error=on_error,
                       device=device)
