"""Region-of-interest coding by the maxshift method (JPEG2000 Part 1 §H) in
the deadzone code domain (counterpart of ``wicca_tpu/codec/roi.py``).

``apply_roi(stream, mask, bg_shift=b)`` post-processes an encoded
:class:`~wicca_tpu_torch.codec.pipeline.CodeStream`:

1. every *background* detail code loses its ``b`` lowest magnitude bits
   (a sign-magnitude shift: a ``2**b`` coarser deadzone quantizer);
2. every *ROI* code is scaled up by ``s`` bits, ``2**s > max |background|``,
   so magnitude alone separates the two and the decoder needs no mask.

The decoder's normalization (``pipeline._normalize_roi``) maps codes back:
``|c| >= 2**s`` is ROI (exact ``>> s``), the rest background (midpoint
``<< b``). ROI codes decode bit for bit as the stream without ROI; the LL is
never touched, so ``icon_from_stream`` is unchanged.

The code-domain mask of level ``l`` is the pixel mask max-pooled by ``2**l``
and dilated by the wavelet's influence margin (haar variants 0, 5/3 2, the
others 4 samples). Everything runs on the stream's tensors where they lie,
in the reference's int64 arithmetic; the shift amount needs the background
maximum, one device-to-host read.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from wicca_tpu_torch.codec.pipeline import CodeStream

# per-level dilation (subband samples) covering the inverse transform's
# influence radius; haar variants are block-structured (no spill)
_MARGINS = {"haar": 0, "haar_int": 0, "legall5.3": 2, "cdf53": 2}


def band_mask(mask, sh: int, sw: int, level: int, margin: int) -> torch.Tensor:
    """Pixel-space bool mask ``(H, W)`` -> bool mask of a level-``level``
    subband of stored extent ``(sh, sw)``: max-pool by ``2**level``, dilate
    by ``margin`` samples (Chebyshev), zero any tile-padding extent. Runs
    where ``mask`` lies (a numpy mask on the CPU)."""
    m = torch.as_tensor(np.asarray(mask, dtype=bool)) if not isinstance(mask, torch.Tensor) else mask.to(torch.bool)
    f = 1 << level
    ph, pw = -(-m.shape[0] // f), -(-m.shape[1] // f)
    pad = torch.zeros((ph * f, pw * f), dtype=torch.bool, device=m.device)
    pad[: m.shape[0], : m.shape[1]] = m
    pooled = pad.reshape(ph, f, pw, f).any(dim=3).any(dim=1)
    if margin:  # separable dilation: rows, then columns
        acc = pooled.clone()
        for d in range(1, margin + 1):
            acc[d:, :] |= pooled[:-d, :]
            acc[:-d, :] |= pooled[d:, :]
        pooled, acc = acc, acc.clone()
        for d in range(1, margin + 1):
            acc[:, d:] |= pooled[:, :-d]
            acc[:, :-d] |= pooled[:, d:]
        pooled = acc
    out = torch.zeros((sh, sw), dtype=torch.bool, device=m.device)
    ch, cw = min(sh, pooled.shape[0]), min(sw, pooled.shape[1])
    out[:ch, :cw] = pooled[:ch, :cw]
    return out


def apply_roi(stream: CodeStream, mask, bg_shift: int = 2, margin: int | None = None) -> CodeStream:
    """Maxshift-ROI a stream. ``mask`` is an ``(H, W)`` bool array or tensor
    in pixel space (True = ROI); ``bg_shift`` in [0, 6] quantizes the
    background ``2**bg_shift`` coarser (about 6 dB per unit; 0 keeps it
    exact and only reorders bit-plane priority for layered streams);
    ``margin`` overrides the per-wavelet dilation.

    Returns a new stream with ``roi_shift``/``bg_shift`` set and the detail
    codes int16 (int32 where the upshifted codes need it), on the stream's
    device. ``decode`` and its partial forms undo it; ``serialize`` writes a
    WCT6 container."""
    if stream.roi_shift:
        raise ValueError("stream is already ROI-coded")
    if not 0 <= bg_shift <= 6:
        raise ValueError(f"bg_shift must be in [0, 6], got {bg_shift}")
    H, W = stream.orig_shape
    dev = stream.ll.device
    mask = (mask.to(device=dev, dtype=torch.bool) if isinstance(mask, torch.Tensor)
            else torch.from_numpy(np.asarray(mask, dtype=bool).copy()).to(dev))
    if tuple(mask.shape) != (H, W):
        raise ValueError(f"mask shape {tuple(mask.shape)} != image {(H, W)}")
    if not bool(mask.any()):
        raise ValueError("ROI mask is empty")
    mg = _MARGINS.get(stream.wavelet, 4) if margin is None else margin
    masks, peaks = [], []
    for lvl0, bands in enumerate(stream.details):
        bm = band_mask(mask, bands[0].shape[-2], bands[0].shape[-1], lvl0 + 1, mg)
        masks.append(bm)
        for b in bands:
            if not b.numel():
                continue
            m = b.to(torch.int64).abs()
            peaks.append(torch.stack([torch.where(bm, 0, m >> bg_shift).amax(), torch.where(bm, m, 0).amax()]))
    max_bg, max_roi = torch.stack(peaks).amax(dim=0).tolist() if peaks else (0, 0)  # one device-to-host read
    s = max(1, max_bg.bit_length())  # 2**s > max |background|
    peak = max(max_roi << s, max_bg)
    dt = torch.int16 if peak < (1 << 15) else torch.int32
    details = []
    for bm, bands in zip(masks, stream.details):
        out = []
        for b in bands:
            v = b.to(torch.int64)
            sg, m = torch.sign(v), v.abs()
            out.append(torch.where(bm, sg * (m << s), sg * (m >> bg_shift)).to(dt))
        details.append(tuple(out))
    return dataclasses.replace(stream, details=tuple(details), roi_shift=s, bg_shift=bg_shift)
