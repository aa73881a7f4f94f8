"""Point-to-point exchanges, all-reduces, block re-layouts and gathers on
``torch.distributed`` groups: what ``jax.shard_map``'s ``ppermute`` and
XLA's resharding do for the JAX package (``wicca_tpu/parallel/``). The mesh
(:mod:`wicca_tpu_torch.parallel`) and the trainer build on it, and the codec
takes a mesh stream through :func:`gather_stream`; it imports nothing of
the port.

Every exchange here goes through :func:`exchange` (``dist.batch_isend_irecv``
on a group, peers named by their rank in the group) or
:func:`all_reduce_start`.
On a gloo group, CUDA tensors travel through pinned host buffers: gloo's
send and recv read host memory, and several ranks sharing one card need
gloo (NCCL refuses two ranks on one GPU). The choice follows the group's
backend; nothing retries on another route after a failure.

:func:`regather` moves the rows (or columns) of a block-distributed axis
from one layout to another: each rank holds a contiguous range of a global
axis, and every rank can compute every rank's ranges, so each rank sends
exactly the rows another rank needs, with no negotiation.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch
import torch.distributed as dist


def staged(group, device: torch.device) -> bool:
    """Whether tensors on ``device`` cross ``group`` through pinned host
    buffers: CUDA tensors on a gloo group."""
    return device.type == "cuda" and dist.get_backend(group) == "gloo"


def _pinned(t: torch.Tensor) -> torch.Tensor:
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    return h


def exchange(sends: dict, recvs: dict, group, device: torch.device) -> dict:
    """Send ``sends[peer]`` to each peer and receive a tensor of
    ``recvs[peer] = (shape, dtype)`` from each peer (peers are ranks in
    ``group``), all in one ``batch_isend_irecv``. Returns the received
    tensors on ``device``."""
    stage = staged(group, device)
    ops = []
    for peer, t in sends.items():
        t = t.contiguous()
        ops.append(dist.P2POp(dist.isend, _pinned(t) if stage else t, dist.get_global_rank(group, peer), group))
    bufs = {}
    for peer, (shape, dtype) in recvs.items():
        bufs[peer] = torch.empty(shape, dtype=dtype, device="cpu" if stage else device, pin_memory=stage)
        ops.append(dist.P2POp(dist.irecv, bufs[peer], dist.get_global_rank(group, peer), group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    if stage:
        return {peer: b.to(device, non_blocking=True) for peer, b in bufs.items()}
    return bufs


def all_reduce_start(t: torch.Tensor, group, op=dist.ReduceOp.SUM):
    """Start ``dist.all_reduce`` of ``t`` over ``group`` (``async_op=True``;
    staged through pinned host memory on a gloo group). Returns ``(work,
    finish)``: once ``work`` has completed, ``finish()`` returns ``t``
    holding the result."""
    if staged(group, t.device):
        h = _pinned(t)
        return dist.all_reduce(h, op=op, group=group, async_op=True), lambda: t.copy_(h)
    return dist.all_reduce(t, op=op, group=group, async_op=True), lambda: t


def all_reduce_(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``dist.all_reduce`` of ``t`` in place over ``group`` (see
    :func:`all_reduce_start`); returns ``t``."""
    if dist.get_world_size(group) == 1:
        return t
    work, finish = all_reduce_start(t, group, op)
    work.wait()
    return finish()


def chunk_bounds(n: int, parts: int) -> list[tuple[int, int]]:
    """DTensor's split of an axis of ``n`` over ``parts`` ranks (the chunks
    of ``torch.chunk``: ``ceil(n / parts)`` a rank, the last ranks shorter
    or empty)."""
    c = -(-n // parts)
    return [(min(i * c, n), min((i + 1) * c, n)) for i in range(parts)]


def even_bounds(n: int, parts: int) -> list[tuple[int, int]]:
    """Equal blocks of an axis that ``parts`` divides."""
    if n % parts:
        raise ValueError(f"an axis of {n} does not split evenly over {parts} ranks")
    b = n // parts
    return [(i * b, (i + 1) * b) for i in range(parts)]


def _positions(idx: np.ndarray, lo: int, hi: int) -> np.ndarray:
    return np.nonzero((idx >= lo) & (idx < hi))[0]


def _index(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64)).to(device)


def regather(local: torch.Tensor, axis: int, src: list, idx: np.ndarray, dst: list, group, me: int) -> torch.Tensor:
    """Re-lay a block-distributed axis. Rank ``i`` of ``group`` holds the
    global positions ``src[i] = (start, stop)`` of ``axis``; afterwards it
    holds positions ``dst[i]`` of the axis ``out[j] = in[idx[j]]``, where
    ``idx[j] = -1`` leaves position ``j`` unset (zero). Only the rows that
    change rank move. ``me`` is this rank in ``group``; the other axes of
    ``local`` must be the same on every rank of ``group``."""
    axis = axis % local.ndim
    dev = local.device
    s0, s1 = src[me]
    sends, self_pos, self_src = {}, None, None
    for q, (d0, d1) in enumerate(dst):
        want = idx[d0:d1]
        pos = _positions(want, s0, s1)
        if q == me:
            self_pos, self_src = pos, want[pos] - s0
        elif pos.size:
            sends[q] = local.index_select(axis, _index(want[pos] - s0, dev))
    d0, d1 = dst[me]
    want = idx[d0:d1]
    recv_pos, recvs = {}, {}
    for p, (a0, a1) in enumerate(src):
        pos = _positions(want, a0, a1)
        if p != me and pos.size:
            recv_pos[p] = pos
            shape = list(local.shape)
            shape[axis] = pos.size
            recvs[p] = (tuple(shape), local.dtype)
    n_out = d1 - d0
    if not sends and not recvs and self_pos.size == n_out and n_out and np.array_equal(
            self_src, np.arange(self_src[0], self_src[0] + n_out)):
        return local.narrow(axis, int(self_src[0]), n_out)  # nothing moves
    got = exchange(sends, recvs, group, dev)
    shape = list(local.shape)
    shape[axis] = n_out
    out = torch.zeros(shape, dtype=local.dtype, device=dev)
    if self_pos.size:
        out.index_copy_(axis, _index(self_pos, dev), local.index_select(axis, _index(self_src, dev)))
    for p, pos in recv_pos.items():
        out.index_copy_(axis, _index(pos, dev), got[p])
    return out


def gather(x):
    """The full tensor of a DTensor, on every rank of its mesh (each
    ``Shard`` dim gathered point to point over its mesh dim's group, staged
    through pinned host memory on a gloo group with CUDA tensors). A plain
    tensor is returned as it is."""
    if not _is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard

    mesh = x.device_mesh
    b = x.to_local()
    for i, p in enumerate(x.placements):
        if isinstance(p, Replicate):
            continue
        if not isinstance(p, Shard):
            raise ValueError(f"gather takes Shard and Replicate placements, got {p}")
        dim, n, k = p.dim % x.ndim, x.shape[p.dim], mesh.shape[i]
        src = chunk_bounds(n, k)
        b = regather(b, dim, src, np.arange(n), [(0, n)] * k, mesh.get_group(i), mesh.get_local_rank(i))
    return b


def _is_dtensor(x) -> bool:
    # a DTensor exists only once its module is loaded, which this module
    # does not do itself (it takes a second)
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def gather_stream(stream):
    """A stream whose tensors are DTensors (a mesh stream, from
    :func:`wicca_tpu_torch.parallel.tiled_encode`) as the same stream of
    full tensors on every rank of its mesh, gathered once; any other stream
    as it is."""
    if not _is_dtensor(stream.ll):
        return stream
    details = tuple(tuple(gather(b) for b in bands) for bands in stream.details)
    return dataclasses.replace(stream, ll=gather(stream.ll), details=details)
