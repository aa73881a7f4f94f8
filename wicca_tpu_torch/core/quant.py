"""Coefficient quantization for the wavelet codec path (counterpart of
``wicca_tpu/core/quant.py``): JPEG2000-style uniform deadzone scalar
quantization of the detail subbands with a per-level step.

Python-float steps meet float32 tensors as float32 values, so every
function here rounds exactly as its jnp counterpart does.
"""

from __future__ import annotations

import dataclasses

import torch

from wicca_tpu_torch.core.haar import Pyramid


def quantize_deadzone(c: torch.Tensor, step: float, dtype=torch.int32) -> torch.Tensor:
    """Uniform deadzone quantizer: q = sign(c) * floor(|c| / step)."""
    return (torch.sign(c) * torch.floor(torch.abs(c) / step)).to(dtype)


def dequantize_deadzone(q: torch.Tensor, step: float, dtype=torch.float32,
                        offset: float = 0.5) -> torch.Tensor:
    """Bin-offset reconstruction: c' = sign(q) * (|q| + offset) * step, 0 -> 0."""
    qf = q.to(dtype)
    return torch.sign(qf) * (torch.abs(qf) + offset) * step


def quantize_midtread(c: torch.Tensor, step: float, dtype=torch.int32) -> torch.Tensor:
    """Round-to-nearest (half to even) uniform quantizer, used for LL."""
    return torch.round(c / step).to(dtype)


def dequantize_midtread(q: torch.Tensor, step: float, dtype=torch.float32) -> torch.Tensor:
    return q.to(dtype) * step


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """Per-subband quantization policy.

    Detail subband at level l (1 = finest) uses ``base_step * level_gain**(l-1)``;
    ``hh_gain`` quantizes the diagonal band that much coarser (visual
    weighting). ``coeff_dtype`` is the dtype of :func:`quantize_deadzone`
    codes outside the fused kernels.
    """

    base_step: float = 1.0
    level_gain: float = 1.0
    ll_step: float = 0.25
    coeff_dtype: torch.dtype = torch.int32
    hh_gain: float = 1.0

    def detail_step(self, level: int) -> float:
        return self.base_step * self.level_gain ** (level - 1)

    def band_steps(self, level: int) -> tuple[float, float, float]:
        """(lh, hl, hh) steps at ``level`` — the storage order of detail
        band triples throughout the codec."""
        s = self.detail_step(level)
        return (s, s, s * self.hh_gain)


def quantize_pyramid(pyr: Pyramid, spec: QuantSpec) -> Pyramid:
    """Quantize a float pyramid to integer codes (same Pyramid structure)."""
    details = tuple(
        tuple(quantize_deadzone(b, s, spec.coeff_dtype) for b, s in zip(bands, spec.band_steps(lvl + 1)))
        for lvl, bands in enumerate(pyr.details)
    )
    ll = quantize_midtread(pyr.ll, spec.ll_step, spec.coeff_dtype)
    return Pyramid(ll=ll, details=details, wavelet=pyr.wavelet, orig_shape=pyr.orig_shape)


def dequantize_pyramid(pyr: Pyramid, spec: QuantSpec) -> Pyramid:
    """The float pyramid of :func:`quantize_pyramid`'s codes."""
    details = tuple(
        tuple(dequantize_deadzone(b, s) for b, s in zip(bands, spec.band_steps(lvl + 1)))
        for lvl, bands in enumerate(pyr.details)
    )
    ll = dequantize_midtread(pyr.ll, spec.ll_step)
    return Pyramid(ll=ll, details=details, wavelet=pyr.wavelet, orig_shape=pyr.orig_shape)
