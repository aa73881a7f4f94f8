"""Sharded images as DTensors, and the rank's blocks of them (what
``NamedSharding`` and XLA's resharding do for the JAX package).

A tiled function works on this rank's block of a global image:

* :func:`take_block` cuts it from the input (a full tensor, the same on
  every rank, or a DTensor in :func:`~wicca_tpu_torch.parallel.mesh.tile_placements`),
  on a padded grid the mesh divides, each padded row and column named by
  the input row or column it copies (-1: a constant). A full tensor is cut
  where it lies; a DTensor's rows move between ranks once.
* :func:`to_dtensor` wraps blocks of the padded grid cropped to the global
  extent as DTensor holds them (``torch.chunk``'s split: ``ceil(n / k)``
  rows a rank); only the rows whose rank changes move.

:func:`wicca_tpu_torch.comm.gather` makes the full tensor on every rank.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from wicca_tpu_torch._device import as_tensor
from wicca_tpu_torch.comm import chunk_bounds, even_bounds, regather
from wicca_tpu_torch.core.pad import _MODE_TO_NP, normalize_border_mode
from wicca_tpu_torch.parallel.mesh import (
    TILE_COL_AXIS,
    TILE_ROW_AXIS,
    axis_index,
    axis_size,
    mesh_device,
    replicated,
    tile_placements,
)


def pad_map(n: int, unit: int, tiles: int, mode="replicate") -> np.ndarray:
    """Source index of every position of an axis of ``n`` padded as
    ``_pad_for_mesh`` pads it: bottom/right to a multiple of ``unit`` in
    ``mode`` (:func:`~wicca_tpu_torch.core.pad.pad_to_multiple`), then with
    its edge (or the constant) to a multiple of ``tiles * unit``; -1 marks a
    constant."""
    mode = normalize_border_mode(mode)
    if mode == "constant":
        m = np.concatenate([np.arange(n), np.full(-n % unit, -1)])
    else:
        m = np.pad(np.arange(n), (0, -n % unit), mode=_MODE_TO_NP[mode])
    extra = -len(m) % (tiles * unit)
    return np.concatenate([m, np.full(extra, -1 if mode == "constant" else m[-1])]).astype(np.int64)


def edge_map(n: int, padded: int) -> np.ndarray:
    """An axis of ``n`` edge-padded to ``padded``."""
    return np.minimum(np.arange(padded), n - 1)


def tile_grid(mesh: DeviceMesh) -> tuple[int, int, int, int]:
    """(ty index, ty size, tx index, tx size) of this rank."""
    return (axis_index(mesh, TILE_ROW_AXIS), axis_size(mesh, TILE_ROW_AXIS),
            axis_index(mesh, TILE_COL_AXIS), axis_size(mesh, TILE_COL_AXIS))


def _check_tiled(x: DTensor, mesh: DeviceMesh) -> None:
    if x.device_mesh != mesh:
        raise ValueError("the DTensor lies on another mesh")
    want = tile_placements(mesh, x.ndim)
    if list(x.placements) != want:
        raise ValueError(f"a tiled image wants placements {want}, got {list(x.placements)}")


def as_input(x, mesh: DeviceMesh):
    """``x`` (numpy, a tensor or a DTensor) as a DTensor on ``mesh`` or a
    tensor on the mesh's device."""
    if isinstance(x, DTensor):
        _check_tiled(x, mesh)
        return x
    dev = mesh_device(mesh)
    if isinstance(x, torch.Tensor) and x.device.type != dev.type:
        raise ValueError(f"the tensor lies on {x.device}, the mesh on {mesh.device_type}")
    return as_tensor(x, dev)


def take_block(x, mesh: DeviceMesh, rows: np.ndarray, cols: np.ndarray, transform=None, constant=0):
    """This rank's block of the padded grid ``grid[..., i, j] =
    transform(x)[..., rows[i], cols[j]]`` (``constant`` where an index is
    -1; ``transform`` acts per pixel), ``len(rows)`` split evenly over
    ``ty`` and ``len(cols)`` over ``tx``."""
    iy, ny, ix, nx = tile_grid(mesh)
    h, w = x.shape[-2], x.shape[-1]
    dst_r, dst_c = even_bounds(len(rows), ny), even_bounds(len(cols), nx)
    if isinstance(x, DTensor):
        b = x.to_local()
        if ny > 1:
            b = regather(b, -2, chunk_bounds(h, ny), rows, dst_r, mesh.get_group(TILE_ROW_AXIS), iy)
        else:
            b = b.index_select(-2, torch.from_numpy(np.maximum(rows, 0)).to(b.device))
        if nx > 1:
            b = regather(b, -1, chunk_bounds(w, nx), cols, dst_c, mesh.get_group(TILE_COL_AXIS), ix)
        else:
            b = b.index_select(-1, torch.from_numpy(np.maximum(cols, 0)).to(b.device))
    else:
        r, c = rows[slice(*dst_r[iy])], cols[slice(*dst_c[ix])]
        b = x.index_select(-2, torch.from_numpy(np.maximum(r, 0)).to(x.device))
        b = b.index_select(-1, torch.from_numpy(np.maximum(c, 0)).to(x.device))
    if transform is not None:
        b = transform(b)
    r, c = rows[slice(*dst_r[iy])], cols[slice(*dst_c[ix])]
    for axis, m in ((-2, r), (-1, c)):
        if (m < 0).any():
            b = b.index_fill(axis, torch.from_numpy(np.nonzero(m < 0)[0]).to(b.device), constant)
    return b


def even_block(x, mesh: DeviceMesh):
    """This rank's block of ``x`` (a full tensor or a tiled DTensor) whose
    trailing dims the mesh divides."""
    if isinstance(x, DTensor):
        _check_tiled(x, mesh)
        _, ny, _, nx = tile_grid(mesh)
        if x.shape[-2] % ny or x.shape[-1] % nx:
            raise ValueError(f"shape {tuple(x.shape)} does not split evenly over the ({ny}, {nx}) tiles")
        return x.to_local()
    return take_block(as_input(x, mesh), mesh, np.arange(x.shape[-2]), np.arange(x.shape[-1]))


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= max(int(n), 1)
    return tuple(reversed(stride))


def to_dtensor(block: torch.Tensor, mesh: DeviceMesh, padded: tuple[int, int], extent: tuple[int, int]) -> DTensor:
    """The DTensor of the global ``grid[..., :extent[0], :extent[1]]``,
    where ``block`` is this rank's even block of a grid of trailing dims
    ``padded``."""
    iy, ny, ix, nx = tile_grid(mesh)
    (ph, pw), (h, w) = padded, extent
    if ny > 1:
        block = regather(block, -2, even_bounds(ph, ny), np.arange(h), chunk_bounds(h, ny),
                         mesh.get_group(TILE_ROW_AXIS), iy)
    else:
        block = block[..., :h, :]
    if nx > 1:
        block = regather(block, -1, even_bounds(pw, nx), np.arange(w), chunk_bounds(w, nx),
                         mesh.get_group(TILE_COL_AXIS), ix)
    else:
        block = block[..., :w]
    shape = torch.Size(tuple(block.shape[:-2]) + (h, w))
    return DTensor.from_local(block, mesh, tile_placements(mesh, block.ndim), run_check=False, shape=shape,
                              stride=_contiguous_stride(shape))


def replicated_dtensor(t: torch.Tensor, mesh: DeviceMesh) -> DTensor:
    """A full tensor that every rank holds as a replicated DTensor."""
    return DTensor.from_local(t, mesh, replicated(mesh), run_check=False)
