"""Tiled wavelet transforms over a (ty, tx) mesh (counterpart of
``wicca_tpu/parallel/tiled.py``).

A large image is split into spatial tiles over ranks (H over ``ty``, W
over ``tx``). Each rank works on its block of the image padded as
:func:`_pad_for_mesh` pads it (the reference padding to ``2**levels``, then
alignment so every level's subbands split evenly). Haar and ``haar_int``
are pair-local; the other lifting wavelets exchange a halo at every lifting
step of every level (:mod:`wicca_tpu_torch.parallel.halo`).

Exactness: the tiled transforms equal the single-device ones of
:mod:`wicca_tpu_torch.core` bit for bit for haar/haar_int at any size, and
for the wide wavelets when the padded dims divide by ``tiles * 2**levels``
(otherwise the alignment padding moves a few boundary coefficients; the
reconstruction is still exact: forward and inverse see the same
extension).

Inputs are a full tensor (the same on every rank) or a DTensor in
:func:`~wicca_tpu_torch.parallel.mesh.tile_placements`; outputs are
DTensors. Every rank of the mesh calls each function together.
"""

from __future__ import annotations

import functools

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from wicca_tpu_torch.comm import all_reduce_, chunk_bounds
from wicca_tpu_torch.core.haar import Pyramid, block_mean_ll, dwt2_level, idwt2_level
from wicca_tpu_torch.core.lifting import _WAVELETS_1D, is_integer_wavelet
from wicca_tpu_torch.parallel.halo import make_shift
from wicca_tpu_torch.parallel.layout import as_input, even_block, pad_map, take_block, tile_grid, to_dtensor
from wicca_tpu_torch.parallel.mesh import TILE_COL_AXIS, TILE_ROW_AXIS, axis_size


def _rows(fn, *arrays):
    out = fn(*(a.transpose(-1, -2) for a in arrays))
    if isinstance(out, tuple):
        return tuple(o.transpose(-1, -2) for o in out)
    return out.transpose(-1, -2)


def _halo_dims(mesh):
    """(tx dim, ty dim) for the shifts: None where the mesh does not split."""
    return (TILE_COL_AXIS if axis_size(mesh, TILE_COL_AXIS) > 1 else None,
            TILE_ROW_AXIS if axis_size(mesh, TILE_ROW_AXIS) > 1 else None)


def _level_fwd_local(x, wavelet: str, mesh):
    """One 2-D level on this rank's tile, halos exchanged where the mesh splits."""
    if wavelet == "haar":
        return dwt2_level(x)
    fwd, _ = _WAVELETS_1D[wavelet]
    if wavelet == "haar_int":
        lo, hi = fwd(x)
        ll, hl = _rows(fwd, lo)
        lh, hh = _rows(fwd, hi)
        return ll, lh, hl, hh
    tx_dim, ty_dim = _halo_dims(mesh)
    sx, sy = make_shift(mesh, tx_dim), make_shift(mesh, ty_dim)
    lo, hi = fwd(x, shift=sx)
    ll, hl = _rows(functools.partial(fwd, shift=sy), lo)
    lh, hh = _rows(functools.partial(fwd, shift=sy), hi)
    return ll, lh, hl, hh


def _level_inv_local(ll, lh, hl, hh, wavelet: str, mesh):
    if wavelet == "haar":
        return idwt2_level(ll, lh, hl, hh)
    _, inv = _WAVELETS_1D[wavelet]
    if wavelet == "haar_int":
        lo = _rows(inv, ll, hl)
        hi = _rows(inv, lh, hh)
        return inv(lo, hi)
    tx_dim, ty_dim = _halo_dims(mesh)
    sx, sy = make_shift(mesh, tx_dim), make_shift(mesh, ty_dim)
    lo = _rows(functools.partial(inv, shift=sy), ll, hl)
    hi = _rows(functools.partial(inv, shift=sy), lh, hh)
    return inv(lo, hi, shift=sx)


def _pad_for_mesh(x, levels: int, mesh, mode, constant, transform=None):
    """This rank's block of ``transform(x)`` padded to ``2**levels`` in
    ``mode``, then (edge, or the constant) so every level's subbands split
    evenly over (ty, tx); and the padded dims."""
    _, ny, _, nx = tile_grid(mesh)
    unit = 1 << levels
    rows = pad_map(x.shape[-2], unit, ny, mode)
    cols = pad_map(x.shape[-1], unit, nx, mode)
    return take_block(x, mesh, rows, cols, transform, constant), (len(rows), len(cols))


def _dwt_local(xl, levels: int, wavelet: str, mesh):
    ll, details = xl, []
    for _ in range(levels):
        ll, lh, hl, hh = _level_fwd_local(ll, wavelet, mesh)
        details.append((lh, hl, hh))
    return ll, details


def _idwt_local(ll, details, wavelet: str, mesh):
    x = ll
    for lh, hl, hh in reversed(details):
        x = _level_inv_local(x, lh, hl, hh, wavelet, mesh)
    return x


def _even(t, mesh, padded):
    return to_dtensor(t, mesh, padded, padded)


def tiled_dwt2(x, levels: int, wavelet: str = "haar", *, mesh, mode="replicate", constant=0) -> Pyramid:
    """Multi-level tiled decomposition; the subbands come back as DTensors
    of the mesh-padded extents (divided by ``2**level``)."""
    if wavelet != "haar" and wavelet not in _WAVELETS_1D:
        raise ValueError(f"Unknown wavelet {wavelet!r}")
    x = as_input(x, mesh)
    orig = (x.shape[-2], x.shape[-1])
    xl, (ph, pw) = _pad_for_mesh(x, levels, mesh, mode, constant)
    xl = xl.to(torch.int32) if is_integer_wavelet(wavelet) else xl.to(torch.float32)
    ll, details = _dwt_local(xl, levels, wavelet, mesh)
    details = tuple(tuple(_even(b, mesh, (ph >> lvl, pw >> lvl)) for b in bands)
                    for lvl, bands in enumerate(details, start=1))
    return Pyramid(ll=_even(ll, mesh, (ph >> levels, pw >> levels)), details=details, wavelet=wavelet,
                   orig_shape=orig)


def tiled_idwt2(pyr: Pyramid, *, mesh):
    """Inverse of :func:`tiled_dwt2`, cropped to the original dims (a
    DTensor)."""
    ll = even_block(pyr.ll, mesh)
    details = [tuple(even_block(b, mesh) for b in bands) for bands in pyr.details]
    x = _idwt_local(ll, details, pyr.wavelet, mesh)
    _, ny, _, nx = tile_grid(mesh)
    padded = (x.shape[-2] * ny, x.shape[-1] * nx)
    return to_dtensor(x, mesh, padded, pyr.orig_shape if pyr.orig_shape is not None else padded)


def tiled_icon(image, depth: int, *, mesh, mode="replicate", constant=0):
    """Reference-parity uint8 icon of a tiled image (a DTensor of
    ``ceil(H / 2**depth) x ceil(W / 2**depth)``; bit for bit: the Haar block
    mean is tile-local at aligned tiles). uint8 runs K1 per shard
    (:func:`wicca_tpu_torch.ops.icon`; its plain twin for CPU tensors);
    other dtypes take the plain block mean."""
    from wicca_tpu_torch.ops.dwt_cuda import icon

    x = as_input(image, mesh)
    h, w = x.shape[-2], x.shape[-1]
    unit = 1 << depth
    xl, (ph, pw) = _pad_for_mesh(x, depth, mesh, mode, constant)
    if xl.dtype == torch.uint8:
        out = icon(xl, depth)
    else:
        out = torch.clamp(block_mean_ll(xl.to(torch.float32), depth), 0, 255).to(torch.uint8)
    return to_dtensor(out, mesh, (ph >> depth, pw >> depth), (-(-h // unit), -(-w // unit)))


def tiled_stats(x, *, mesh) -> dict:
    """Global mean / std / min / max of a tiled image: float32 sums of this
    rank's block, all-reduced over ``ty`` and ``tx``."""
    x = as_input(x, mesh)
    if isinstance(x, DTensor):
        xl = x.to_local()
    else:
        iy, ny, ix, nx = tile_grid(mesh)
        r0, r1 = chunk_bounds(x.shape[-2], ny)[iy]
        c0, c1 = chunk_bounds(x.shape[-1], nx)[ix]
        xl = x[..., r0:r1, c0:c1]
    xl = xl.to(torch.float32)
    dev = xl.device
    sums = torch.stack([torch.tensor(float(xl.numel()), device=dev), xl.sum(), (xl * xl).sum()])
    empty = xl.numel() == 0
    ends = torch.stack([torch.tensor(float("inf"), device=dev) if empty else xl.min(),
                        torch.tensor(float("inf"), device=dev) if empty else -xl.max()])
    for name in (TILE_ROW_AXIS, TILE_COL_AXIS):
        if axis_size(mesh, name) > 1:
            group = mesh.get_group(name)
            all_reduce_(sums, group)
            all_reduce_(ends, group, dist.ReduceOp.MIN)
    n, s, s2 = sums
    mean = s / n
    var = torch.clamp(s2 / n - mean * mean, min=0.0)
    return {"mean": float(mean), "std": float(torch.sqrt(var)), "min": float(ends[0]), "max": float(-ends[1])}
