"""Data-parallel batched codec over the mesh's ``data`` dim (counterpart of
``wicca_tpu/parallel/batch.py``): same-sized images stack into ``(N, C, H,
W)`` and each rank of ``data`` takes its rows; every op of the codec is per
image, so nothing crosses ranks until the per-image results are gathered.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from wicca_tpu_torch.codec.pipeline import decode, encode
from wicca_tpu_torch.comm import even_bounds, regather
from wicca_tpu_torch.core.pad import pad_to_multiple
from wicca_tpu_torch.core.quant import QuantSpec
from wicca_tpu_torch.ops.dwt_cuda import icon
from wicca_tpu_torch.parallel.layout import _contiguous_stride, as_input
from wicca_tpu_torch.parallel.mesh import DATA_AXIS, axis_index, axis_size, batch_placements


def _pad_batch(images: torch.Tensor, mesh) -> tuple[torch.Tensor, int]:
    """N padded to a multiple of the ``data`` size by repeating the last
    image; callers crop the outputs back to N."""
    n = images.shape[0]
    extra = -n % axis_size(mesh, DATA_AXIS)
    if extra:
        images = torch.cat([images, images[-1:].expand(extra, *images.shape[1:])], dim=0)
    return images, n


def _rows(images, mesh) -> tuple[torch.Tensor, int]:
    """This rank's rows of the padded batch, and N."""
    images, n = _pad_batch(as_input(images, mesh), mesh)
    lo, hi = even_bounds(images.shape[0], axis_size(mesh, DATA_AXIS))[axis_index(mesh, DATA_AXIS)]
    return images[lo:hi], n


def _gather_rows(rows: torch.Tensor, mesh) -> torch.Tensor:
    """The padded batch's rows from every rank of ``data``, on every rank."""
    k = axis_size(mesh, DATA_AXIS)
    if k == 1:
        return rows
    total = rows.shape[0] * k
    return regather(rows, 0, even_bounds(total, k), np.arange(total), [(0, total)] * k,
                    mesh.get_group(DATA_AXIS), axis_index(mesh, DATA_AXIS))


def dp_encode_decode_psnr(images, levels: int, spec: QuantSpec = QuantSpec(), *, mesh) -> torch.Tensor:
    """Batch ``(N, C, H, W)`` uint8 -> per-image PSNR of the quantized Haar
    roundtrip (K2/K3 on each rank's images), the same ``(N,)`` float32
    tensor on every rank."""
    x, n = _rows(images, mesh)
    rec = decode(encode(x, levels=levels, spec=spec))
    d = rec - x.to(torch.float32)
    per_mse = torch.mean(d * d, dim=tuple(range(1, x.ndim)))
    psnr = 10.0 * torch.log10(255.0 * 255.0 / torch.clamp(per_mse, min=1e-30))
    return _gather_rows(psnr, mesh)[:n]


def dp_icons(images, depth: int, *, mesh):
    """Batch ``(N, C, H, W)`` uint8 -> ``(N, C, ceil(H / 2**depth), ceil(W /
    2**depth))`` uint8 icons as a DTensor split over ``data``: K1 on each
    rank's images (its plain twin for CPU tensors); bit for bit the single
    image icon."""
    x, n = _rows(images, mesh)
    out = icon(pad_to_multiple(x, 1 << depth), depth)
    # the padded batch splits as DTensor splits N: drop the repeated rows
    lo = out.shape[0] * axis_index(mesh, DATA_AXIS)
    out = out[: max(0, min(out.shape[0], n - lo))]
    shape = torch.Size((n,) + tuple(out.shape[1:]))
    return DTensor.from_local(out, mesh, batch_placements(mesh), run_check=False, shape=shape,
                              stride=_contiguous_stride(shape))


def depth_sweep_psnr(images, depths, spec: QuantSpec = QuantSpec(), *, mesh) -> dict:
    """Mean PSNR per depth of a batch split over ``data`` (the reference
    benchmark's depth sweep)."""
    return {d: float(torch.mean(dp_encode_decode_psnr(images, d, spec, mesh=mesh))) for d in depths}
