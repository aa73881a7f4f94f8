"""Image-quality metrics for the codec path (counterpart of
``wicca_tpu/core/metrics.py``: ``mse`` and ``psnr``)."""

from __future__ import annotations

import math

import torch


def mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d = a.to(torch.float32) - b.to(torch.float32)
    return torch.mean(d * d)


def psnr(a: torch.Tensor, b: torch.Tensor, peak: float = 255.0) -> torch.Tensor:
    """Peak signal-to-noise ratio in dB; inf for identical inputs."""
    m = mse(a, b)
    db = 10.0 * torch.log10(peak * peak / torch.clamp(m, min=1e-30))
    return torch.where(m == 0, torch.full_like(m, math.inf), db)
