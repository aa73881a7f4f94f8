"""Stream transcoding: rewrite a ``.wct`` file without running the wavelet
transform again (counterpart of ``wicca_tpu/codec/transcode.py``):

* ``max_layers`` keeps a prefix of an SNR-layered stream (a coarser step);
* ``drop_levels`` drops the finest detail levels: a valid stream of the
  1/2**r-resolution image, decoding as ``decode_at_level(orig, r)`` does;
* ``codec``, ``quality_layers`` and ``ll_codec`` re-code the planes.

Everything is host work on codes (entropy decode, reshape, entropy encode),
so :func:`transcode` loads onto the CPU and never touches the card. The
result's bytes equal the reference's for the same file and options;
metadata is kept.
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path

from wicca_tpu_torch.codec.container import load, peek_layers, save
from wicca_tpu_torch.codec.pipeline import CodeStream


def drop_finest_levels(stream: CodeStream, r: int) -> CodeStream:
    """Drop the finest ``r`` detail levels: a depth-(L-r) stream of the
    1/2**r-resolution image, decoding as ``decode_at_level(stream, r)``.

    Old level l becomes level l-r, so ``base_step`` absorbs
    ``level_gain**r``. Only geometry-free transforms re-root this way: the
    Haar variants (pair-local) and ``layout='global'`` lifting streams; wide
    tile-local streams would need the encoder's pass-aligned tile grid and
    are refused (``decode_at_level`` reads them)."""
    if not 0 <= r < stream.levels:
        raise ValueError(f"drop_levels must be in [0, {stream.levels - 1}], got {r}")
    if r == 0:
        return stream
    if stream.layout == "tiled" and stream.wavelet not in ("haar", "haar_int"):
        raise ValueError(
            f"cannot re-root a tiled {stream.wavelet!r} stream (tile grids are "
            "pass-aligned); decode_at_level() instead"
        )
    h, w = stream.orig_shape
    scale = 1 << r
    spec = dataclasses.replace(stream.spec, base_step=stream.spec.base_step * stream.spec.level_gain**r)
    return dataclasses.replace(
        stream,
        details=stream.details[r:],
        levels=stream.levels - r,
        orig_shape=(-(-h // scale), -(-w // scale)),
        spec=spec,
        # the R-D divisor table indexes planes fine to coarse
        band_div=stream.band_div[3 * r :] if stream.band_div else (),
    )


def transcode(
    src: str | os.PathLike,
    dst: str | os.PathLike,
    max_layers: int | None = None,
    drop_levels: int = 0,
    codec: str = "auto",
    quality_layers: int | None = None,
    threads: int = 8,
    allow_truncated: bool = False,
    on_error: str = "raise",
    ll_codec: str = "raw",
    ll_step: float = 0.125,
) -> dict:
    """Rewrite ``src`` -> ``dst`` with layer truncation, level drops and
    codec or layering changes; returns size metrics.

    ``quality_layers=None`` keeps the source's layering (after
    ``max_layers``), so a codec-only rewrite of a layered stream stays
    progressive. ``ll_codec`` rewrites the LL storage (WC10); a loaded WC10
    stream saves raw unless asked again."""
    src, dst = Path(src), Path(dst)
    if quality_layers is None:
        quality_layers = peek_layers(str(src))
        if max_layers is not None:
            quality_layers = max(1, min(quality_layers, max_layers))
    stream = load(str(src), threads=threads, max_layers=max_layers, allow_truncated=allow_truncated,
                  on_error=on_error, device="cpu")
    stream = drop_finest_levels(stream, drop_levels)
    bytes_out = save(stream, str(dst), threads=threads, codec=codec, quality_layers=quality_layers,
                     ll_codec=ll_codec, ll_step=ll_step)
    bytes_in = src.stat().st_size
    return {
        "bytes_in": bytes_in,
        "bytes_out": bytes_out,
        "ratio": round(bytes_in / max(bytes_out, 1), 3),
        "levels": stream.levels,
        "orig_shape": tuple(stream.orig_shape),
    }
