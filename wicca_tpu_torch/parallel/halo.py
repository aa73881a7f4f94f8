"""Halo exchange for tiled wavelet transforms (counterpart of
``wicca_tpu/parallel/halo.py``).

Each lifting step reads at most one sample of the other polyphase channel
across a tile boundary, so one exchange of ``|k|`` columns with a neighbour
per shifted read suffices. Ranks at the global boundary replicate their
edge, as the single-device clamped shift (``core.lifting._shift``) does, so
a tiled transform equals the single-device one (exactly for the integer
wavelets, to float32 rounding for the float ones).

Every rank of the mesh dim calls these together (SPMD); the exchange is
point to point on the dim's group (:func:`~wicca_tpu_torch.comm.exchange`).
:data:`HALO` counts this rank's exchanges and the bytes it sent.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from wicca_tpu_torch.comm import exchange
from wicca_tpu_torch.core.lifting import _shift

# this rank's halo exchanges and the bytes it sent, since reset_halo_counts()
HALO = {"exchanges": 0, "bytes": 0}


def reset_halo_counts() -> None:
    HALO["exchanges"] = HALO["bytes"] = 0


def shift_halo(x: torch.Tensor, k: int, mesh, dim: str) -> torch.Tensor:
    """Distributed :func:`~wicca_tpu_torch.core.lifting._shift`: ``x`` is
    this rank's block of a global array split along its last axis over mesh
    dim ``dim``; returns this rank's block of the global ``x[n + k]`` with
    the edge replicated at the global boundary. Interior boundaries take
    the ``|k|`` columns they need from the neighbour."""
    if k == 0:
        return x
    group = mesh.get_group(dim)
    n = dist.get_world_size(group)
    if n == 1:
        return _shift(x, k)
    idx = mesh.get_local_rank(dim)
    m = abs(k)
    if m > x.shape[-1]:
        raise ValueError("halo wider than local block")
    if k > 0:  # the first m columns of the right neighbour
        send = {idx - 1: x[..., :m]} if idx > 0 else {}
        recv = {idx + 1: (tuple(x.shape[:-1]) + (m,), x.dtype)} if idx < n - 1 else {}
    else:  # the last m columns of the left neighbour
        send = {idx + 1: x[..., -m:]} if idx < n - 1 else {}
        recv = {idx - 1: (tuple(x.shape[:-1]) + (m,), x.dtype)} if idx > 0 else {}
    got = exchange(send, recv, group, x.device)
    HALO["exchanges"] += 1
    HALO["bytes"] += sum(t.numel() * t.element_size() for t in send.values())
    if k > 0:
        tail = got[idx + 1] if recv else x[..., -1:].expand(*x.shape[:-1], m)
        return torch.cat([x[..., m:], tail], dim=-1)
    head = got[idx - 1] if recv else x[..., :1].expand(*x.shape[:-1], m)
    return torch.cat([head, x[..., :-m]], dim=-1)


def make_shift(mesh, dim: str | None):
    """Shift for the lifting functions (their ``shift=``): the local clamp
    when ``dim`` is None, else the halo exchange over mesh dim ``dim``."""
    if dim is None:
        return _shift
    return lambda a, k: shift_halo(a, k, mesh, dim)
