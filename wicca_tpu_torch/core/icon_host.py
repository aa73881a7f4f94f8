"""Host (numpy) icons: the harness's host route, bit-exact with the icon
kernel K1 (counterpart of ``wicca_tpu/core/icon_host.py``).

The harness takes it where the measured link makes uploading full-resolution
frames cost more than summing them here (``harness/processor.py``
``_icon_route``).

Exactness: for uint8 input at depth <= 6 every icon pixel is
``sum(block) * 0.25**d`` with ``sum(block) <= 4096*255 < 2**24`` and at most
12 fractional bits, so it is exact in float32; integer block sums scaled
once by an exact power of two give K1's values (and its plain twin's) bit
for bit (``tests/test_torch_harness.py`` holds it against K1's twin and
against the JAX module).

``icons_multi`` reuses the integer pyramid: block sums at depth d+1 are sums
of four depth-d sums (exact), so a depth sweep costs one pass over the
full-resolution image plus geometrically shrinking follow-ups.
"""

from __future__ import annotations

import time

import numpy as np

from wicca_tpu_torch.utils.ema import RateEMA

# measured host icon throughput (MP/s over source pixels), an EMA: an input
# of the harness's routing
_mps = RateEMA(120.0, min_units=0.25)


def measured_mp_per_s() -> float:
    return _mps.rate()


def _record(mp: float, seconds: float) -> None:
    _mps.record(mp, seconds)


def _pad_replicate(x: np.ndarray, unit: int) -> np.ndarray:
    h, w = x.shape[-2], x.shape[-1]
    dh, dw = (-h) % unit, (-w) % unit
    if not dh and not dw:
        return x
    pw = [(0, 0)] * (x.ndim - 2) + [(0, dh), (0, dw)]
    return np.pad(x, pw, mode="edge")


def _block_sums(x: np.ndarray) -> np.ndarray:
    """Exact int32 sums of 2x2 blocks of the last two dims."""
    h, w = x.shape[-2], x.shape[-1]
    r = x.reshape(x.shape[:-2] + (h // 2, 2, w)).sum(axis=-2, dtype=np.int32)
    return r.reshape(r.shape[:-1] + (w // 2, 2)).sum(axis=-1, dtype=np.int32)


def _emit(sums: np.ndarray, depth: int) -> np.ndarray:
    icon = sums.astype(np.float32) * np.float32(0.25**depth)
    return np.clip(icon, 0, 255).astype(np.uint8)


def icon_host(planar_u8: np.ndarray, depth: int) -> np.ndarray:
    """Depth-d icon of a planar ``(..., H, W)`` uint8 image, equal to K1's
    on the image replicate-padded to ``2**depth`` (padding only extends
    bottom/right, so the crop keeps the same pixels)."""
    return icons_multi(planar_u8, (depth,))[depth]


def icons_multi(planar_u8: np.ndarray, depths) -> dict[int, np.ndarray]:
    """Icons at every requested depth from one integer cascade (exact)."""
    t0 = time.perf_counter()
    depths = sorted(set(int(d) for d in depths))
    if not depths or depths[0] < 1:
        raise ValueError(f"depths must be >= 1, got {depths}")
    x = np.asarray(planar_u8)
    if x.dtype != np.uint8:
        raise TypeError(f"icon_host wants uint8, got {x.dtype}")
    h, w = x.shape[-2], x.shape[-1]
    unit = 1 << max(depths)
    # replicate-padding to 2**max(depths) equals per-depth 2**d padding on
    # every kept pixel: extra rows/cols only extend bottom/right, and the
    # last kept block's replicated values are the same either way
    sums = _pad_replicate(x, unit)  # u8; _block_sums widens to int32
    out: dict[int, np.ndarray] = {}
    level = 0
    for d in depths:
        while level < d:
            sums = _block_sums(sums)
            level += 1
        out[d] = _emit(sums, d)[..., : -(-h // (1 << d)), : -(-w // (1 << d))]
    _record(h * w / 1e6, time.perf_counter() - t0)
    return out
