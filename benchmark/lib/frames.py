"""Photograph-like uint8 frames made from a seed, on any device.

The field is ``chip_smoke.py``'s ``photo_like``: three octaves of noise (4,
16 and 64 pixels) upsampled bilinearly, plus pixel noise around 128, made
here with a ``torch.Generator`` on the device that holds the frame, so a
53.5 MP frame takes milliseconds on a card. The same seed gives the same
frame on the same kind of device.
"""

from __future__ import annotations

import hashlib

import torch


def derive(seed: int, *parts) -> int:
    """A 63-bit seed for one use of the run's ``seed`` (any whole number)."""
    text = ":".join(str(p) for p in (seed, *parts))
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8], "little") >> 1


def _up4(g: torch.Tensor) -> torch.Tensor:
    """Bilinear 4x upsampling of ``(c, a, b)`` to ``(c, 4(a-1), 4(b-1))``."""
    c, a, b = g.shape
    f = (torch.arange(4, dtype=torch.float32, device=g.device) + 0.5) / 4
    r = (g[:, :-1, None, :] * (1 - f)[:, None] + g[:, 1:, None, :] * f[:, None]).reshape(c, (a - 1) * 4, b)
    return (r[:, :, :-1, None] * (1 - f) + r[:, :, 1:, None] * f).reshape(c, (a - 1) * 4, (b - 1) * 4)


def photo_like(shape, seed: int, device) -> torch.Tensor:
    """A planar ``(c, h, w)`` uint8 frame from ``seed`` on ``device``."""
    c, h, w = shape
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def noise(a, b, amp):
        return torch.randn((c, a, b), generator=gen, device=device) * amp

    hq, wq = h // 4 + 2, w // 4 + 2
    field = noise(hq, wq, 18.0)
    field += _up4(noise(hq // 4 + 2, wq // 4 + 2, 30.0))[:, :hq, :wq]
    field += _up4(_up4(noise(hq // 16 + 3, wq // 16 + 3, 42.0)))[:, :hq, :wq]
    img = _up4(field)[:, :h, :w]
    img += noise(h, w, 3.0)
    img += 128.0
    return img.clamp_(0, 255).to(torch.uint8)


def expand(frames) -> list[tuple[int, int, int]]:
    """A traffic mix's frame list: ``[c, h, w]`` entries, or ``{"shape":
    [c, h, w], "count": n}`` for ``n`` frames of one shape."""
    out = []
    for f in frames:
        if isinstance(f, dict):
            out.extend([tuple(f["shape"])] * int(f["count"]))
        else:
            out.append(tuple(f))
    return out
