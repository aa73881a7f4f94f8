"""The Haar image codec: fused DWT + deadzone quantization encode, fused
dequantization + inverse DWT decode (counterpart of
``wicca_tpu/codec/pipeline.py``, 8-bit Haar path).

``encode`` -> :class:`CodeStream` (int8/int16 detail codes + float32 LL)
``decode`` -> reconstructed image, cropped to the original dims.

Every level partition, shape and rounding step follows the JAX package, so
streams cross between the two (:mod:`wicca_tpu_torch.codec.interop`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from wicca_tpu_torch._device import as_tensor
from wicca_tpu_torch.core.pad import pad_to_multiple, unpad
from wicca_tpu_torch.core.quant import QuantSpec
from wicca_tpu_torch.ops.dwt_cuda import contiguous_aligned, dwt_multilevel_quant, idwt_multilevel_dequant

# where each missing piece of the codec is scheduled (ROADMAP.md, Queue 1)
_LATER = {
    "wavelet": "Queue 1 item 7 (remaining codec surface: lifting wavelets, kernels K6-K9)",
    "color": "Queue 1 item 7 (core/color.py rct/ict)",
    "bit_depth": "Queue 1 item 7 (the 9-16-bit int32 path)",
    "roi": "Queue 1 item 7 (codec/roi.py)",
}


def _not_yet(what: str, value) -> NotImplementedError:
    return NotImplementedError(f"{what}={value!r} is not ported yet: {_LATER[what]}")


def _pass_sizes(levels: int) -> list[int]:
    """Fine-side partition of a multi-level transform into fused passes of
    <= 3 levels (the encoder's grouping; decode mirrors it)."""
    sizes = []
    lvl = 0
    while lvl < levels:
        sizes.append(min(3, levels - lvl))
        lvl += sizes[-1]
    return sizes


def _crop_semantic(ll, details, h_sem: int, w_sem: int, levels: int):
    """Keep each stored subband's semantic extent (h_sem, w_sem are the dims
    after the 2**levels padding). Valid for the pair-local Haar transform."""
    ll = ll[..., : h_sem >> levels, : w_sem >> levels]
    out = []
    for lvl, bands in enumerate(details, start=1):
        out.append(tuple(b[..., : h_sem >> lvl, : w_sem >> lvl] for b in bands))
    return ll, out


@dataclasses.dataclass(frozen=True)
class CodeStream:
    """Quantized multi-level representation, with the fields of the JAX
    package's ``CodeStream``. ``details[k]`` = (lh, hl, hh) codes of level
    k+1 (finest first); ``ll`` = float32 coarse band. ``band_div`` holds the
    per-plane step divisors of R-D truncation (() = all 1)."""

    ll: torch.Tensor
    details: tuple[tuple[torch.Tensor, torch.Tensor, torch.Tensor], ...]
    spec: QuantSpec
    levels: int
    orig_shape: tuple[int, int]
    wavelet: str = "haar"
    color: str = "none"
    chroma_gain: float = 1.0
    layout: str = "tiled"
    bit_depth: int = 8
    roi_shift: int = 0
    bg_shift: int = 0
    metadata: tuple[tuple[str, bytes], ...] = ()
    band_div: tuple[int, ...] = ()

    def num_bytes(self) -> int:
        n = self.ll.numel() * self.ll.element_size()
        for bands in self.details:
            for b in bands:
                n += b.numel() * b.element_size()
        return n


def encode(
    image,
    levels: int = 5,
    spec: QuantSpec = QuantSpec(),
    mode: str = "replicate",
    constant: int = 0,
    wavelet: str = "haar",
    color: str = "none",
    chroma_gain: float = 1.0,
    bit_depth: int | None = None,
    device=None,
) -> CodeStream:
    """Planar ``(..., H, W)`` uint8 or float image -> :class:`CodeStream`.

    A tensor is encoded where it lies; a numpy array on ``device`` (CUDA
    unless the caller says otherwise). uint8 input stays uint8 into the first
    fused pass (integer-exact early levels); any other dtype is cast to
    float32 first."""
    x = as_tensor(image, device)
    if bit_depth is None:
        bit_depth = 16 if x.dtype == torch.uint16 else 8
    if not 8 <= bit_depth <= 16:
        raise ValueError(f"bit_depth must be in [8, 16], got {bit_depth}")
    if color not in ("none", "rct", "ict"):
        raise ValueError(f"color must be none|rct|ict, got {color!r}")
    if levels < 1:
        raise ValueError("levels must be >= 1")
    if bit_depth != 8:
        raise _not_yet("bit_depth", bit_depth)
    if color != "none":
        raise _not_yet("color", color)
    if wavelet != "haar":
        raise _not_yet("wavelet", wavelet)
    orig = (x.shape[-2], x.shape[-1])
    x = pad_to_multiple(x, 1 << levels, mode=mode, constant=constant)
    if x.dtype != torch.uint8:
        x = x.to(torch.float32)
    h_sem, w_sem = x.shape[-2], x.shape[-1]
    ll = x
    details = []
    lvl = 0
    for k in _pass_sizes(levels):
        ll = contiguous_aligned(ll[..., : h_sem >> lvl, : w_sem >> lvl])
        steps = tuple(spec.band_steps(lvl + i + 1) for i in range(k))
        ll, dets = dwt_multilevel_quant(ll, steps)
        details.extend(dets)
        lvl += k
    ll, details = _crop_semantic(ll, details, h_sem, w_sem, levels)
    return CodeStream(
        ll=ll, details=tuple(details), spec=spec, levels=levels, orig_shape=orig,
        wavelet=wavelet, color=color, chroma_gain=chroma_gain, layout="tiled", bit_depth=bit_depth,
    )


def _scaled_steps(stream: CodeStream, lvl: int) -> tuple[float, float, float]:
    """Effective dequantization steps for level ``lvl``: the spec's band
    steps times the plane's R-D truncation divisor (float64 products; the
    kernels round them to float32)."""
    s = stream.spec.band_steps(lvl)
    if not stream.band_div:
        return s
    d = stream.band_div[(lvl - 1) * 3 : (lvl - 1) * 3 + 3]
    return (s[0] * d[0], s[1] * d[1], s[2] * d[2])


def _check_decodable(stream: CodeStream) -> None:
    if stream.wavelet != "haar":
        raise _not_yet("wavelet", stream.wavelet)
    if stream.color != "none":
        raise _not_yet("color", stream.color)
    if stream.bit_depth != 8:
        raise _not_yet("bit_depth", stream.bit_depth)
    if stream.roi_shift:
        raise _not_yet("roi", stream.roi_shift)


def decode(stream: CodeStream, emit_u8: bool = False, recon_offset: float = 0.5) -> torch.Tensor:
    """CodeStream -> reconstructed image (original dims), float32, or uint8
    with ``emit_u8`` (clipped and cast inside the finest fused pass).
    ``recon_offset`` is the deadzone reconstruction point as a fraction of
    the bin (0.5 = midpoint). Runs where the stream's tensors lie."""
    _check_decodable(stream)
    x = stream.ll.to(torch.float32)
    hi = stream.levels
    for k in reversed(_pass_sizes(stream.levels)):
        lo = hi - k  # this pass covers levels lo+1..hi
        dets = [tuple(contiguous_aligned(b) for b in stream.details[i]) for i in range(lo, hi)]
        steps = tuple(_scaled_steps(stream, i + 1) for i in range(lo, hi))
        ch, cw = dets[-1][0].shape[-2], dets[-1][0].shape[-1]
        x = contiguous_aligned(x[..., :ch, :cw])
        x = idwt_multilevel_dequant(x, dets, steps, emit_u8=emit_u8 and lo == 0, recon_offset=recon_offset)
        hi = lo
    return unpad(x, *stream.orig_shape)


def icon_from_stream(stream: CodeStream) -> torch.Tensor:
    """uint8 icon straight from the coarse band (free at decode time)."""
    _check_decodable(stream)
    return torch.clamp(stream.ll, 0, 255).to(torch.uint8)


def compression_ratio(stream: CodeStream) -> float:
    """Raw uint8 bytes vs *stored* code bytes (about 1 for int8 codes; the
    entropy coder provides the size win, see :func:`entropy_ratio`)."""
    h, w = stream.orig_shape
    lead = int(stream.ll.numel() // (stream.ll.shape[-2] * stream.ll.shape[-1]))
    return (lead * h * w) / stream.num_bytes()


def estimated_entropy_bytes(stream: CodeStream) -> float:
    """Shannon-entropy size of the detail codes + raw LL bytes — what an
    order-0 entropy coder approaches."""
    total = float(stream.ll.numel() * stream.ll.element_size())
    for bands in stream.details:
        for b in bands:
            codes = b.detach().cpu().numpy().ravel()
            _, counts = np.unique(codes, return_counts=True)
            p = counts / codes.size
            bits = float(-(p * np.log2(p)).sum()) * codes.size
            total += bits / 8.0
    return total


def entropy_ratio(stream: CodeStream) -> float:
    """Raw uint8 bytes vs entropy-coded size estimate."""
    h, w = stream.orig_shape
    lead = int(stream.ll.numel() // (stream.ll.shape[-2] * stream.ll.shape[-1]))
    return (lead * h * w) / max(estimated_entropy_bytes(stream), 1.0)
