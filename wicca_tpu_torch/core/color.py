"""Color transforms for the codec path — plain PyTorch (counterpart of
``wicca_tpu/core/color.py``).

* RCT — reversible color transform (lossless path, pairs with LeGall 5/3):
    Y = (R + 2G + B) >> 2 ;  U = B - G ;  V = R - G
  exactly invertible in int32 via G = Y - ((U + V) >> 2).
* ICT — irreversible BT.601 YCbCr (lossy path), float32.

All functions take planar ``(..., 3, H, W)`` tensors, channel axis third
from last; the codec's steps (``rct_fwd_codec``/``rct_inv_codec``,
``ict_fwd_codec``/``ict_inv_codec``) also take RGBA, whose alpha plane
bypasses the rotation.
"""

from __future__ import annotations

import torch


def rct_fwd(x: torch.Tensor) -> torch.Tensor:
    """Planar RGB int -> (Y, U, V) int32."""
    x = x.to(torch.int32)
    r, g, b = x[..., 0, :, :], x[..., 1, :, :], x[..., 2, :, :]
    y = (r + 2 * g + b) >> 2
    return torch.stack([y, b - g, r - g], dim=-3)


def rct_inv(x: torch.Tensor) -> torch.Tensor:
    """Exact inverse of :func:`rct_fwd` (int32 -> int32 RGB)."""
    x = x.to(torch.int32)
    y, u, v = x[..., 0, :, :], x[..., 1, :, :], x[..., 2, :, :]
    g = y - ((u + v) >> 2)
    return torch.stack([v + g, g, u + g], dim=-3)


# BT.601 full-range ICT (JPEG2000 irreversible component transform)
_ICT = (
    (0.299, 0.587, 0.114),
    (-0.168736, -0.331264, 0.5),
    (0.5, -0.418688, -0.081312),
)
_ICT_INV = (
    (1.0, 0.0, 1.402),
    (1.0, -0.344136, -0.714136),
    (1.0, 1.772, 0.0),
)


def _mix(x: torch.Tensor, rows) -> torch.Tensor:
    x = x.to(torch.float32)
    a, b, c = x[..., 0, :, :], x[..., 1, :, :], x[..., 2, :, :]
    return torch.stack([m[0] * a + m[1] * b + m[2] * c for m in rows], dim=-3)


def ict_fwd(x: torch.Tensor) -> torch.Tensor:
    """Planar RGB -> YCbCr float32 (Cb/Cr zero-centered)."""
    return _mix(x, _ICT)


def ict_inv(x: torch.Tensor) -> torch.Tensor:
    return _mix(x, _ICT_INV)


def split_alpha(x: torch.Tensor):
    """(the three color planes, the alpha plane or None) of planar input."""
    return (x[..., :3, :, :], x[..., 3:, :, :]) if x.shape[-3] == 4 else (x, None)


def join_alpha(rgb: torch.Tensor, extra) -> torch.Tensor:
    return rgb if extra is None else torch.cat([rgb, extra.to(rgb.dtype)], dim=-3)


def chroma_factors(gains: tuple[float, float, float], like: torch.Tensor) -> torch.Tensor:
    """Per-plane float32 factors (Y, Cb, Cr) that broadcast over (..., 3, H, W)."""
    return torch.tensor(gains, dtype=torch.float32, device=like.device).reshape(3, 1, 1)


def rct_fwd_codec(x: torch.Tensor) -> torch.Tensor:
    """The codec's forward reversible step: planar RGB or RGBA -> (Y, U, V)
    int32, alpha carried as int32."""
    rgb, extra = split_alpha(x)
    return join_alpha(rct_fwd(rgb), extra)


def rct_inv_codec(x: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`rct_fwd_codec` (int32 RGB or RGBA)."""
    yuv, extra = split_alpha(x)
    return join_alpha(rct_inv(yuv), extra)


def ict_fwd_codec(x: torch.Tensor, chroma_gain: float = 1.0) -> torch.Tensor:
    """The codec's forward color step: planar RGB or RGBA -> YCbCr float32
    with the chroma planes divided by ``chroma_gain`` (alpha carried as
    float32)."""
    rgb, extra = split_alpha(x)
    yuv = ict_fwd(rgb)
    if chroma_gain != 1.0:
        yuv = yuv * chroma_factors((1.0, 1.0 / chroma_gain, 1.0 / chroma_gain), yuv)
    return join_alpha(yuv, extra)


def ict_inv_codec(x: torch.Tensor, chroma_gain: float = 1.0) -> torch.Tensor:
    """Inverse of :func:`ict_fwd_codec` (float32 RGB or RGBA)."""
    yuv, extra = split_alpha(x)
    if chroma_gain != 1.0:
        yuv = yuv * chroma_factors((1.0, chroma_gain, chroma_gain), yuv)
    return join_alpha(ict_inv(yuv), extra)
