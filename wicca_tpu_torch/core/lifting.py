"""Lifting-scheme wavelet transforms — plain PyTorch (counterpart of
``wicca_tpu/core/lifting.py``).

Every transform is a sequence of lifting steps along the last axis; the row
pass reuses the same code on the transpose. Boundaries replicate the edge by
index clamping, which keeps every step exactly invertible for any signal
length (each step only adds a function of the other polyphase channel).

Integer wavelets (``haar_int``, ``legall5.3``/``cdf53``) run in int32, where
``>>`` is an arithmetic shift (floor division), as in jnp:

    haar_int:  d = o - e ; s = e + (d >> 1)
    legall5.3: d[n] = o[n] - ((e[n] + e[n+1]) >> 1)
               s[n] = e[n] + ((d[n-1] + d[n] + 2) >> 2)

Float wavelets (``db2``, ``cdf97``/``bior4.4``) run in float32 with the
reference's constants and step order; Python-float constants meet float32
tensors as float32 values.
"""

from __future__ import annotations

import math

import torch

from wicca_tpu_torch.core.haar import Pyramid, _interleave
from wicca_tpu_torch.core.pad import pad_to_multiple, unpad

# ---------------------------------------------------------------------------
# 1-D helpers (last axis)
# ---------------------------------------------------------------------------


def _split_pairs(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Even/odd elements along the last axis."""
    return x[..., 0::2], x[..., 1::2]


def _shift(x: torch.Tensor, k: int) -> torch.Tensor:
    """x[n+k] along the last axis with edge replication (clamped indexing)."""
    if k == 0:
        return x
    n = x.shape[-1]
    idx = torch.clamp(torch.arange(n, device=x.device) + k, 0, n - 1)
    return x.index_select(-1, idx)


# ---------------------------------------------------------------------------
# Integer Haar (S-transform) and LeGall 5/3 — exactly invertible in int32
# ---------------------------------------------------------------------------


def haar_int_fwd1d(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    e, o = _split_pairs(x)
    d = o - e
    s = e + (d >> 1)
    return s, d


def haar_int_inv1d(s: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    e = s - (d >> 1)
    o = d + e
    return _interleave(e, o, axis=-1)


def legall53_fwd1d(x: torch.Tensor, shift=_shift) -> tuple[torch.Tensor, torch.Tensor]:
    """LeGall 5/3 analysis (the JPEG2000 lossless filter); DC gain of ``s`` is 1."""
    e, o = _split_pairs(x)
    d = o - ((e + shift(e, +1)) >> 1)
    s = e + ((shift(d, -1) + d + 2) >> 2)
    return s, d


def legall53_inv1d(s: torch.Tensor, d: torch.Tensor, shift=_shift) -> torch.Tensor:
    e = s - ((shift(d, -1) + d + 2) >> 2)
    o = d + ((e + shift(e, +1)) >> 1)
    return _interleave(e, o, axis=-1)


# ---------------------------------------------------------------------------
# Float lifting wavelets: db2 (D4) and bior4.4 (CDF 9/7)
# ---------------------------------------------------------------------------

_SQ3 = math.sqrt(3.0)
_SQ2 = math.sqrt(2.0)
# D4 lifting factorization, rescaled so the lowpass DC gain is 1
_D4_SCALE_S = (_SQ3 - 1.0) / _SQ2 / _SQ2
_D4_SCALE_D = (_SQ3 + 1.0) / _SQ2 / _SQ2

# CDF 9/7 lifting coefficients (JPEG2000 irreversible path)
_A97 = -1.586134342059924
_B97 = -0.052980118572961
_G97 = 0.882911075530934
_D97 = 0.443506852043971
_K97 = 1.230174104914001  # lowpass DC response of the lifting chain


def db2_fwd1d(x: torch.Tensor, shift=_shift) -> tuple[torch.Tensor, torch.Tensor]:
    e, o = _split_pairs(x)
    s1 = e + _SQ3 * o
    d1 = o - (_SQ3 / 4.0) * s1 - ((_SQ3 - 2.0) / 4.0) * shift(s1, -1)
    s2 = s1 - shift(d1, +1)
    return _D4_SCALE_S * s2, _D4_SCALE_D * d1


def db2_inv1d(s: torch.Tensor, d: torch.Tensor, shift=_shift) -> torch.Tensor:
    s2 = s / _D4_SCALE_S
    d1 = d / _D4_SCALE_D
    s1 = s2 + shift(d1, +1)
    o = d1 + (_SQ3 / 4.0) * s1 + ((_SQ3 - 2.0) / 4.0) * shift(s1, -1)
    e = s1 - _SQ3 * o
    return _interleave(e, o, axis=-1)


def cdf97_fwd1d(x: torch.Tensor, shift=_shift) -> tuple[torch.Tensor, torch.Tensor]:
    e, o = _split_pairs(x)
    d = o + _A97 * (e + shift(e, +1))
    s = e + _B97 * (shift(d, -1) + d)
    d = d + _G97 * (s + shift(s, +1))
    s = s + _D97 * (shift(d, -1) + d)
    return s / _K97, d * _K97


def cdf97_inv1d(s: torch.Tensor, d: torch.Tensor, shift=_shift) -> torch.Tensor:
    s = s * _K97
    d = d / _K97
    s = s - _D97 * (shift(d, -1) + d)
    d = d - _G97 * (s + shift(s, +1))
    s = s - _B97 * (shift(d, -1) + d)
    o = d - _A97 * (s + shift(s, +1))
    return _interleave(s, o, axis=-1)


_WAVELETS_1D = {
    "haar_int": (haar_int_fwd1d, haar_int_inv1d),
    "legall5.3": (legall53_fwd1d, legall53_inv1d),
    "cdf53": (legall53_fwd1d, legall53_inv1d),
    "db2": (db2_fwd1d, db2_inv1d),
    "bior4.4": (cdf97_fwd1d, cdf97_inv1d),
    "cdf97": (cdf97_fwd1d, cdf97_inv1d),
}

# integer (reversible) wavelets: transforms run in int32 and invert exactly
_INT_WAVELETS = frozenset({"haar_int", "legall5.3", "cdf53"})


def is_integer_wavelet(name: str) -> bool:
    return name in _INT_WAVELETS


def lifting_wavelets() -> tuple[str, ...]:
    return tuple(_WAVELETS_1D)


def register_wavelet(name: str, fwd1d, inv1d) -> None:
    """Add a wavelet as a pair of last-axis lifting functions
    ``fwd1d(x) -> (s, d)`` and ``inv1d(s, d) -> x``."""
    _WAVELETS_1D[name] = (fwd1d, inv1d)


# ---------------------------------------------------------------------------
# 2-D separable levels + pyramids
# ---------------------------------------------------------------------------


def _rows(fn, *arrays):
    """Apply a last-axis function along the second-to-last axis."""
    out = fn(*(a.transpose(-1, -2) for a in arrays))
    if isinstance(out, tuple):
        return tuple(o.transpose(-1, -2) for o in out)
    return out.transpose(-1, -2)


def dwt2_level_lifting(x: torch.Tensor, wavelet: str):
    """One separable 2-D level, horizontal filtering first, then vertical.
    Returns ``(ll, lh, hl, hh)`` with XY = (vertical, horizontal) naming."""
    fwd, _ = _WAVELETS_1D[wavelet]
    lo, hi = fwd(x)
    ll, hl = _rows(fwd, lo)
    lh, hh = _rows(fwd, hi)
    return ll, lh, hl, hh


def idwt2_level_lifting(ll, lh, hl, hh, wavelet: str) -> torch.Tensor:
    _, inv = _WAVELETS_1D[wavelet]
    lo = _rows(inv, ll, hl)
    hi = _rows(inv, lh, hh)
    return inv(lo, hi)


def dwt2_lifting(x: torch.Tensor, levels: int, wavelet: str = "haar_int", mode="replicate",
                 constant=0) -> Pyramid:
    """Multi-level lifting decomposition. Integer wavelets keep int32."""
    if levels < 1:
        raise ValueError("levels must be >= 1")
    if wavelet not in _WAVELETS_1D:
        raise ValueError(f"Unknown wavelet {wavelet!r}; have {sorted(_WAVELETS_1D)}")
    orig = (x.shape[-2], x.shape[-1])
    x = pad_to_multiple(x, 2**levels, mode=mode, constant=constant)
    ll = x.to(torch.int32) if is_integer_wavelet(wavelet) else x.to(torch.float32)
    details = []
    for _ in range(levels):
        ll, lh, hl, hh = dwt2_level_lifting(ll, wavelet)
        details.append((lh, hl, hh))
    return Pyramid(ll=ll, details=tuple(details), wavelet=wavelet, orig_shape=orig)


def idwt2_lifting(pyr: Pyramid) -> torch.Tensor:
    """Inverse multi-level lifting transform; crops to the original dims."""
    x = pyr.ll
    for lh, hl, hh in reversed(pyr.details):
        x = idwt2_level_lifting(x, lh, hl, hh, pyr.wavelet)
    if pyr.orig_shape is not None:
        x = unpad(x, *pyr.orig_shape)
    return x
