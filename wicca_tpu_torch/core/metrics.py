"""Image-quality metrics for the codec path (counterpart of
``wicca_tpu/core/metrics.py``): ``mse``, ``psnr``, and block-windowed
``ssim``/``ms_ssim``, plain PyTorch on the inputs where they lie."""

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


def _blocks(a: torch.Tensor, window: int) -> torch.Tensor:
    """The trailing two axes cut into non-overlapping ``window`` blocks (odd
    tails cropped): ``(..., h/window, window, w/window, window)``."""
    h, w = a.shape[-2], a.shape[-1]
    hh, ww = h - h % window, w - w % window
    return a[..., :hh, :ww].reshape(*a.shape[:-2], hh // window, window, ww // window, window)


def _moments(a: torch.Tensor, b: torch.Tensor, window: int):
    """Per-window means, variances and covariance of ``a`` and ``b``."""
    sa, sb = _blocks(a, window), _blocks(b, window)
    axes = (-3, -1)
    mu_a, mu_b = sa.mean(dim=axes), sb.mean(dim=axes)
    cov = (sa * sb).mean(dim=axes) - mu_a * mu_b
    return mu_a, mu_b, sa.var(dim=axes, correction=0), sb.var(dim=axes, correction=0), cov


def _ssim_parts(a: torch.Tensor, b: torch.Tensor, peak: float, window: int):
    """Mean luminance and mean contrast-structure terms of SSIM, the two
    factors :func:`ms_ssim` needs apart."""
    mu_a, mu_b, var_a, var_b, cov = _moments(a, b, window)
    c1, c2 = (0.01 * peak) ** 2, (0.03 * peak) ** 2
    lum = (2 * mu_a * mu_b + c1) / (mu_a**2 + mu_b**2 + c1)
    cs = (2 * cov + c2) / (var_a + var_b + c2)
    return torch.mean(lum), torch.mean(cs)


def _downsample2(x: torch.Tensor) -> torch.Tensor:
    """2x2 mean pool of the trailing two axes (odd tails cropped)."""
    h, w = x.shape[-2] // 2 * 2, x.shape[-1] // 2 * 2
    return x[..., :h, :w].reshape(*x.shape[:-2], h // 2, 2, w // 2, 2).mean(dim=(-3, -1))


def ssim(a: torch.Tensor, b: torch.Tensor, peak: float = 255.0, window: int = 8) -> torch.Tensor:
    """Mean structural similarity over non-overlapping ``window`` blocks of
    the trailing two axes (uniform window, the standard K1/K2 constants)."""
    mu_a, mu_b, var_a, var_b, cov = _moments(a.to(torch.float32), b.to(torch.float32), window)
    c1, c2 = (0.01 * peak) ** 2, (0.03 * peak) ** 2
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / ((mu_a**2 + mu_b**2 + c1) * (var_a + var_b + c2))
    return torch.mean(s)


def ms_ssim(a: torch.Tensor, b: torch.Tensor, peak: float = 255.0, window: int = 8) -> torch.Tensor:
    """Multi-scale SSIM (Wang et al. 2003): contrast-structure terms at up to
    5 dyadic scales (2x2 mean pool between them) and the luminance term at
    the coarsest, with the canonical exponents; scales smaller than one
    window are dropped and the weights renormalized. Negative terms are
    clamped to 1e-6 before the fractional powers."""
    weights = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)
    a, b = a.to(torch.float32), b.to(torch.float32)
    m = min(a.shape[-2], a.shape[-1])
    n = 1
    while n < len(weights) and (m >> n) >= window:
        n += 1
    wsum = sum(weights[:n])
    out = torch.ones((), dtype=torch.float32, device=a.device)
    for i, wt in enumerate(weights[:n]):
        lum, cs = _ssim_parts(a, b, peak, window)
        term = lum * cs if i == n - 1 else cs
        out = out * torch.clamp(term, min=1e-6) ** (wt / wsum)
        if i < n - 1:
            a, b = _downsample2(a), _downsample2(b)
    return out
