"""The PACK1 kernels of the packed stream transfer and their plain PyTorch
twins (the device side of :mod:`wicca_tpu_torch.codec.transfer`).

Each wrapper, its plain twin, and what it replaces in the JAX package
(``wicca_tpu/codec/transfer.py``, jnp under ``jax.jit`` there, not Pallas):

* P1 :func:`pack1_stats` / :func:`pack1_stats_plain` — ``_stats_fn``: per
  plane and k = 1..width-1, the max over SEG-sample segments of the samples
  whose zigzag code is >= 2**k - 1;
* P2 :func:`pack1_pack` / :func:`pack1_pack_plain` — ``_pack_fn``: a
  stream's packed buffer (k-bit fields, per-segment escape rows, raw
  passthrough where k == width, then the LL's bytes);
* P3 :func:`pack1_unpack` / :func:`pack1_unpack_plain` —
  ``_unpack_plane_fn``: an upload's fields and corrections back to planes.

The twins follow the JAX functions op for op (``_zigzag_jnp``,
``_pack_fields_jnp``, ``_unpack_fields_jnp``), with a stable descending
sort in place of ``lax.top_k`` (whose ties also go to the lower index).
Codes are held as int32 here: torch has no uint16 arithmetic.

A wrapper takes its plain twin only for tensors on the CPU. For CUDA
tensors it launches its kernel (``csrc/pack_kernels.cu``), once per
:data:`MAX_PLANES` planes, or raises; nothing falls back. Each launch adds
one to :data:`LAUNCHES`; each wrapper call is the span ``ops.<wrapper>``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from wicca_tpu_torch.ops import _build
from wicca_tpu_torch.ops.dwt_cuda import _require_cuda, contiguous_aligned, launch_on_card
from wicca_tpu_torch.utils.timing import spanned

SEG = 4096  # escape-compaction segment (samples); kSeg in csrc/pack_kernels.cuh
MAX_PLANES = 40  # planes per launch; kMaxPlanes there

# launches per wrapper since the last reset_launches()
LAUNCHES = {"pack1_stats": 0, "pack1_pack": 0, "pack1_unpack": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _width(dtype: torch.dtype) -> int:
    if dtype == torch.int8:
        return 8
    if dtype == torch.int16:
        return 16
    raise ValueError(f"PACK1 packs int8 or int16 code planes, got {dtype}")


def _npad(n: int) -> int:
    return -(-n // SEG) * SEG


def _nwords(k: int) -> int:
    return (8 * k + 31) // 32


# ---------------------------------------------------------------------------
# the twins' building blocks
# ---------------------------------------------------------------------------


def zigzag(c: torch.Tensor, width: int) -> torch.Tensor:
    """Integer codes -> their ``width``-bit zigzag codes, as int32."""
    ci = c.to(torch.int32)
    z = (ci << 1) ^ (ci >> 31)
    return z & ((1 << width) - 1)  # the uint8 / uint16 cast


def unzigzag(z: torch.Tensor, width: int) -> torch.Tensor:
    """``width``-bit zigzag codes -> int8 / int16 codes."""
    zi = z.to(torch.int32)
    c = (zi >> 1) ^ -(zi & 1)
    return c.to(torch.int8 if width == 8 else torch.int16)


def pack_fields(z: torch.Tensor, k: int) -> torch.Tensor:
    """(n,) codes < 2**k, n % 8 == 0 -> (n * k // 8,) uint8: each group of
    8 assembled in ceil(8k/32) little-endian 32-bit words, cut to k bytes."""
    g = z.reshape(-1, 8).to(torch.int64)
    words = [torch.zeros(g.shape[0], dtype=torch.int64, device=z.device) for _ in range(_nwords(k))]
    for s in range(8):
        off = s * k
        w0, sh = off >> 5, off & 31
        words[w0] = words[w0] | ((g[:, s] << sh) & 0xFFFFFFFF)
        if sh + k > 32:
            words[w0 + 1] = words[w0 + 1] | (g[:, s] >> (32 - sh))
    by = torch.stack([((words[i >> 2] >> (8 * (i & 3))) & 255).to(torch.uint8) for i in range(4 * len(words))],
                     dim=1)
    return by[:, :k].reshape(-1)


def unpack_fields(b: torch.Tensor, k: int) -> torch.Tensor:
    """(n * k // 8,) uint8 -> (n,) int32 field values (:func:`pack_fields`'s
    inverse)."""
    nw = _nwords(k)
    g = b.reshape(-1, k).to(torch.int64)
    if 4 * nw > k:
        g = torch.cat([g, torch.zeros((g.shape[0], 4 * nw - k), dtype=torch.int64, device=b.device)], dim=1)
    words = [sum(g[:, 4 * w + i] << (8 * i) for i in range(1, 4)) + g[:, 4 * w] for w in range(nw)]
    cols = []
    for s in range(8):
        off = s * k
        w0, sh = off >> 5, off & 31
        v = words[w0] >> sh
        if sh + k > 32:
            v = v | (words[w0 + 1] << (32 - sh))
        cols.append(v & ((1 << k) - 1))
    return torch.stack(cols, dim=1).reshape(-1).to(torch.int32)


def _value_bytes(v: torch.Tensor, width: int) -> torch.Tensor:
    """int32 values < 2**width -> their little-endian bytes (uint8)."""
    if width == 8:
        return v.reshape(-1).to(torch.uint8)
    return torch.stack([v & 255, v >> 8], dim=-1).reshape(-1).to(torch.uint8)


def _bytes_value(b: torch.Tensor, width: int) -> torch.Tensor:
    """Little-endian bytes -> int32 values of ``width`` bits."""
    if width == 8:
        return b.to(torch.int32)
    w = b.reshape(-1, 2).to(torch.int32)
    return w[:, 0] | (w[:, 1] << 8)


def _padded_codes(p: torch.Tensor) -> torch.Tensor:
    """A plane's zigzag codes, zero-padded to a multiple of SEG."""
    z = zigzag(p.reshape(-1), _width(p.dtype))
    return torch.nn.functional.pad(z, (0, _npad(z.numel()) - z.numel()))


# ---------------------------------------------------------------------------
# P1: escape-tail statistics
# ---------------------------------------------------------------------------


def pack1_stats_plain(planes) -> torch.Tensor:
    """For each plane and k = 1..width-1, the max over SEG-sample segments
    of #{zigzag code >= 2**k - 1} (int32, the planes' rows concatenated)."""
    outs = []
    for p in planes:
        seg = _padded_codes(p).reshape(-1, SEG)
        outs.append(torch.stack([(seg >= (1 << k) - 1).sum(dim=1).max() for k in range(1, _width(p.dtype))]))
    return torch.cat(outs).to(torch.int32)


def _chunks(items):
    return [items[i : i + MAX_PLANES] for i in range(0, len(items), MAX_PLANES)]


def _arrays(ctype, values):
    return (ctype * len(values))(*values)


def _launch_stats(lib, planes, stream: int) -> torch.Tensor:
    """P1's launches through ``lib`` on ``stream`` (planes already checked)."""
    widths = [_width(p.dtype) for p in planes]
    offs = [sum(w - 1 for w in widths[:i]) for i in range(len(planes))]
    out = torch.zeros(sum(w - 1 for w in widths), dtype=torch.int32, device=planes[0].device)
    for idx in _chunks(list(range(len(planes)))):
        rc = lib.wicca_pack1_stats(len(idx), _arrays(ctypes.c_void_p, [planes[i].data_ptr() for i in idx]),
                                   _arrays(ctypes.c_int64, [planes[i].numel() for i in idx]),
                                   _arrays(ctypes.c_int64, [offs[i] for i in idx]),
                                   _arrays(ctypes.c_int32, [widths[i] for i in idx]), out.data_ptr(), stream)
        _build.check(rc, "pack1_stats")
        LAUNCHES["pack1_stats"] += 1
    return out


def _checked(name: str, planes) -> list:
    if not planes:
        raise ValueError(f"{name}: no planes")
    for p in planes:
        _width(p.dtype)
    if planes[0].device.type == "cpu":
        return list(planes)
    planes = [contiguous_aligned(p) for p in planes]
    _require_cuda(name, *planes)
    return planes


@spanned("ops.pack1_stats")
def pack1_stats(planes) -> torch.Tensor:
    """P1 over a stream's int8/int16 detail planes (one launch per
    :data:`MAX_PLANES` planes)."""
    planes = _checked("pack1_stats", planes)
    if planes[0].device.type == "cpu":
        return pack1_stats_plain(planes)
    return launch_on_card(planes[0].get_device(), _launch_stats, planes)


# ---------------------------------------------------------------------------
# P2: the packed buffer
# ---------------------------------------------------------------------------


def packed_layout(sizes, kcs) -> tuple[list[int], int]:
    """Each plane's byte offset in the packed buffer, from its ``(samples,
    width)`` and ``(k, cap)``, and the offset of the LL's bytes, which end
    the buffer."""
    offs, off = [], 0
    for (n, width), (k, cap) in zip(sizes, kcs):
        offs.append(off)
        npad = _npad(n)
        off += npad * (width // 8) if k == width else npad * k // 8 + (npad // SEG) * cap * (width // 8)
    return offs, off


def pack1_pack_plain(planes, kcs, ll: torch.Tensor) -> torch.Tensor:
    """The packed buffer of ``planes`` at their ``(k, cap)`` and ``ll``:
    per plane, k == width: the padded zigzag codes; else the k-bit fields
    saturated at 2**k - 1 and, per segment, the values of its first ``cap``
    samples by (escape first, then position); then the LL's bytes."""
    parts = []
    for p, (k, cap) in zip(planes, kcs):
        width = _width(p.dtype)
        z = _padded_codes(p)
        if k == width:
            parts.append(_value_bytes(z, width))
            continue
        marker = (1 << k) - 1
        parts.append(pack_fields(torch.minimum(z, torch.tensor(marker, dtype=z.dtype, device=z.device)), k))
        seg = z.reshape(-1, SEG)
        key = torch.where(seg >= marker, SEG - torch.arange(SEG, dtype=torch.int32, device=z.device), 0)
        idx = torch.sort(key, dim=1, descending=True, stable=True).indices[:, :cap]
        parts.append(_value_bytes(torch.take_along_dim(seg, idx, dim=1), width))
    parts.append(ll.contiguous().reshape(-1).view(torch.uint8))
    return torch.cat(parts)


def _launch_pack(lib, planes, kcs, ll: torch.Tensor, stream: int) -> torch.Tensor:
    """P2's launches through ``lib`` on ``stream`` (inputs already checked)."""
    ll_bytes = ll.reshape(-1).view(torch.uint8)
    offs, ll_off = packed_layout([(p.numel(), _width(p.dtype)) for p in planes], kcs)
    buf = torch.empty(ll_off + ll_bytes.numel(), dtype=torch.uint8, device=planes[0].device)
    items = [(p.data_ptr(), p.numel(), off, _width(p.dtype), k, cap, 0) for p, off, (k, cap) in zip(planes, offs, kcs)]
    items.append((ll_bytes.data_ptr(), ll_bytes.numel(), ll_off, 8, 8, 0, 1))
    for chunk in _chunks(items):
        cols = list(zip(*chunk))
        rc = lib.wicca_pack1_pack(len(chunk), _arrays(ctypes.c_void_p, cols[0]), _arrays(ctypes.c_int64, cols[1]),
                                  _arrays(ctypes.c_int64, cols[2]), *(_arrays(ctypes.c_int32, c) for c in cols[3:]),
                                  buf.data_ptr(), stream)
        _build.check(rc, "pack1_pack")
        LAUNCHES["pack1_pack"] += 1
    return buf


def _check_kcs(planes, kcs) -> None:
    if len(kcs) != len(planes):
        raise ValueError(f"{len(kcs)} (k, cap) pairs for {len(planes)} planes")
    for p, (k, cap) in zip(planes, kcs):
        width = _width(p.dtype)
        if not 1 <= k <= width or not 0 <= cap <= SEG:
            raise ValueError(f"(k, cap) = {(k, cap)} for a {width}-bit plane")


@spanned("ops.pack1_pack")
def pack1_pack(planes, kcs, ll: torch.Tensor) -> torch.Tensor:
    """P2: the packed buffer of a stream (one launch per :data:`MAX_PLANES`
    parts, the LL being one)."""
    planes = _checked("pack1_pack", planes)
    _check_kcs(planes, kcs)
    if planes[0].device.type == "cpu":
        return pack1_pack_plain(planes, kcs, ll)
    ll = contiguous_aligned(ll)
    _require_cuda("pack1_pack", planes[0], ll)
    return launch_on_card(planes[0].get_device(), _launch_pack, planes, kcs, ll)


# ---------------------------------------------------------------------------
# P3: an upload's fields and corrections -> planes
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class UnpackPlane:
    """Where one plane lies in an upload buffer: its fields (``k`` bits a
    sample; k == width: its raw zigzag codes) at byte ``off``, and
    ``ncorr`` int32 positions (non-decreasing) at ``pos_off`` (4-aligned)
    with their width-bit values at ``val_off``."""

    shape: tuple
    width: int
    k: int
    off: int
    ncorr: int = 0
    pos_off: int = 0
    val_off: int = 0

    @property
    def n(self) -> int:
        return math.prod(self.shape)


def pack1_unpack_plain(buf: torch.Tensor, layout) -> list[torch.Tensor]:
    """The planes of ``layout`` (:class:`UnpackPlane`) out of ``buf``: the
    fields' codes, ``z[pos] = val`` for the positions inside the padded
    plane (others dropped), unzigzagged to int8/int16 of the stored shape."""
    out = []
    for u in layout:
        npad = _npad(u.n)
        if u.k == u.width:
            z = _bytes_value(buf[u.off : u.off + npad * (u.width // 8)], u.width)
        else:
            z = unpack_fields(buf[u.off : u.off + npad * u.k // 8], u.k)
            if u.ncorr:
                pos = buf[u.pos_off : u.pos_off + 4 * u.ncorr].view(torch.int32).to(torch.int64)
                vals = _bytes_value(buf[u.val_off : u.val_off + u.ncorr * (u.width // 8)], u.width)
                keep = (pos >= 0) & (pos < npad)
                z = z.index_put((pos[keep],), vals[keep])
        out.append(unzigzag(z[: u.n], u.width).reshape(u.shape))
    return out


def _launch_unpack(lib, buf: torch.Tensor, layout, stream: int) -> list[torch.Tensor]:
    """P3's launches through ``lib`` on ``stream`` (inputs already checked)."""
    out = [torch.empty(u.shape, dtype=torch.int8 if u.width == 8 else torch.int16, device=buf.device)
           for u in layout]
    items = [(o.data_ptr(), u.n, u.off, u.pos_off, u.val_off, u.ncorr, u.width, u.k) for o, u in zip(out, layout)]
    for chunk in _chunks(items):
        cols = list(zip(*chunk))
        rc = lib.wicca_pack1_unpack(len(chunk), _arrays(ctypes.c_void_p, cols[0]),
                                    *(_arrays(ctypes.c_int64, c) for c in cols[1:5]),
                                    *(_arrays(ctypes.c_int32, c) for c in cols[5:]), buf.data_ptr(), stream)
        _build.check(rc, "pack1_unpack")
        LAUNCHES["pack1_unpack"] += 1
    return out


def _check_layout(buf: torch.Tensor, layout) -> None:
    if buf.dtype != torch.uint8 or buf.ndim != 1:
        raise ValueError(f"pack1_unpack wants a flat uint8 buffer, got {buf.dtype}{tuple(buf.shape)}")
    if not layout:
        raise ValueError("pack1_unpack: no planes")
    for u in layout:
        if u.width not in (8, 16) or not 1 <= u.k <= u.width or u.n == 0:
            raise ValueError(f"pack1_unpack: bad plane {u}")
        end = u.off + (_npad(u.n) * u.k // 8)
        if u.ncorr:
            if u.pos_off % 4:
                raise ValueError(f"pack1_unpack: positions at byte {u.pos_off} are not 4-aligned")
            end = max(end, u.pos_off + 4 * u.ncorr, u.val_off + u.ncorr * (u.width // 8))
        if end > buf.numel():
            raise ValueError(f"pack1_unpack: plane {u} reaches byte {end} of a {buf.numel()}-byte buffer")


@spanned("ops.pack1_unpack")
def pack1_unpack(buf: torch.Tensor, layout) -> list[torch.Tensor]:
    """P3: the planes of an upload buffer (one launch per
    :data:`MAX_PLANES` planes), on the buffer's device."""
    _check_layout(buf, layout)
    if buf.device.type == "cpu":
        return pack1_unpack_plain(buf, layout)
    buf = contiguous_aligned(buf)
    _require_cuda("pack1_unpack", buf)
    return launch_on_card(buf.get_device(), _launch_unpack, buf, layout)
