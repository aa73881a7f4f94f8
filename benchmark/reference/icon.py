"""Plain LL icon: the depth-``d`` Haar LL band of a uint8 frame, scaled to
pixel values, as ``wicca_tpu``'s ``HaarCoder.get_small_copy`` gives it:
the frame's last row and column repeated up to a multiple of ``2**d``,
each ``2**d x 2**d`` block's mean, truncated to uint8. Integer block sums
are exact; for ``d <= 6`` so is the reference's float32 scaling."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def icon(x: torch.Tensor, depth: int) -> torch.Tensor:
    """``x``: planar ``(c, h, w)`` uint8 -> ``(c, ceil(h/2**d), ceil(w/2**d))`` uint8."""
    if not 1 <= depth <= 6:
        raise ValueError("the plain icon is exact for depths 1-6")
    unit = 1 << depth
    c, h, w = x.shape
    v = x.to(torch.int64)
    ph, pw = -h % unit, -w % unit
    if ph or pw:
        v = F.pad(v[None].double(), (0, pw, 0, ph), mode="replicate")[0].to(torch.int64)
    sums = v.reshape(c, v.shape[1] // unit, unit, v.shape[2] // unit, unit).sum(dim=(2, 4))
    return torch.div(sums, unit * unit, rounding_mode="floor").to(torch.uint8)
