"""The codec over a (ty, tx) mesh (counterpart of
``wicca_tpu/parallel/codec.py``): ``tiled_encode`` makes a regular
:class:`~wicca_tpu_torch.codec.pipeline.CodeStream` whose tensors are
DTensors, the same stream the single-device encoder makes; ``serialize``
and the decoders take it (gathering it once), and ``tiled_decode`` is its
sharded inverse.

Per-shard kernels, no halo:

* haar (K2/K3) and haar_int (K6/K7) are pair-local, so each rank runs the
  single-device pass kernels on its block, and the gathered stream equals
  the single-device encoder's bit for bit at any mesh shape. Stored
  subbands are cropped to their semantic extent on both paths, which is
  what keeps the streams independent of the mesh.
* legall5.3 clamps at every (512, 1024) tile of a pass. Where the image
  aligns each rank's tile grid with the single-device encoder's
  (:func:`mesh53_aligned`), each rank runs K6/K7 and the stream again
  equals the single-device one; otherwise it takes the halo path.

Halo path: the other wavelets (db2, bior4.4/cdf97, registered ones) and
unaligned legall5.3 compute the whole-image transform with a halo exchange
at every lifting step (:mod:`wicca_tpu_torch.parallel.tiled`), in plain
PyTorch as the reference leaves it to XLA; such streams carry
``layout='global'``.

The color transforms run plain before the transform and after the inverse,
as the reference runs them here. A tile-local wide-wavelet stream that
cannot map onto the mesh decodes on every rank from the gathered stream,
as the reference decodes it on one device.
"""

from __future__ import annotations

import dataclasses

import torch

from wicca_tpu_torch.codec.pipeline import (
    CodeStream,
    _emit_native,
    _normalize_roi,
    _pass_sizes,
    _scaled_steps,
    _undo_color,
    _widen_div_int,
    decode,
)
from wicca_tpu_torch.core.color import ict_fwd_codec, rct_fwd_codec
from wicca_tpu_torch.core.lifting import is_integer_wavelet
from wicca_tpu_torch.core.quant import QuantSpec, dequantize_deadzone, quantize_deadzone
from wicca_tpu_torch.ops.dwt53_cuda import dwt53_multilevel, idwt53_multilevel
from wicca_tpu_torch.ops.dwt_cuda import (
    _TILE_H,
    _TILE_W,
    contiguous_aligned,
    dwt_multilevel_quant,
    idwt_multilevel_dequant,
)
from wicca_tpu_torch.parallel.layout import (
    as_input,
    edge_map,
    even_block,
    replicated_dtensor,
    take_block,
    tile_grid,
    to_dtensor,
)
from wicca_tpu_torch.parallel.tiled import _dwt_local, _idwt_local, _pad_for_mesh


def mesh53_aligned(h_sem: int, w_sem: int, ty: int, tx: int, levels: int) -> bool:
    """True when every fused 5/3 pass's input dims are multiples of
    ``(ty * 512, tx * 1024)``: then each rank's tile grid is the
    single-device encoder's (same tiles, same edge clamps) and the per-shard
    kernels reproduce the single-device stream."""
    start = 0
    for k in _pass_sizes(levels):
        if (h_sem >> start) % (ty * _TILE_H) or (w_sem >> start) % (tx * _TILE_W):
            return False
        start += k
    return True


def _fused_encode_local(xl, levels: int, spec: QuantSpec, wavelet: str):
    """This rank's passes over its (lh, lw) block (K2 for haar, K6 for the
    integer wavelets), each pass's tile padding cropped back to the local
    semantic extent."""
    lh, lw = xl.shape[-2], xl.shape[-1]
    ll, dets, lvl = xl, [], 0
    for k in _pass_sizes(levels):
        ll = contiguous_aligned(ll[..., : lh >> lvl, : lw >> lvl])
        if wavelet == "haar":
            ll, d = dwt_multilevel_quant(ll, tuple(spec.band_steps(lvl + i + 1) for i in range(k)))
        else:
            ll, d = dwt53_multilevel(ll, k, filt=wavelet)
        for i, bands in enumerate(d, start=1):
            g = lvl + i
            dets.append(tuple(b[..., : lh >> g, : lw >> g] for b in bands))
        lvl += k
    return ll[..., : lh >> levels, : lw >> levels], dets


def _color_step(color: str, chroma_gain: float):
    if color == "rct":
        return rct_fwd_codec
    if color == "ict":
        return lambda b: ict_fwd_codec(b, chroma_gain)
    return None


def tiled_encode(
    image,
    levels: int = 5,
    spec: QuantSpec = QuantSpec(),
    wavelet: str = "haar",
    *,
    mesh,
    mode: str = "replicate",
    constant: int = 0,
    color: str = "none",
    chroma_gain: float = 1.0,
) -> CodeStream:
    """Planar ``(..., H, W)`` image (a full tensor or a tiled DTensor) ->
    CodeStream of DTensors.

    The contract of :func:`wicca_tpu_torch.codec.encode` (the integer
    wavelets are lossless and ignore ``spec``). haar and haar_int (always)
    and legall5.3 (where :func:`mesh53_aligned`) run the pass kernels per
    shard and give the single-device encoder's stream; the other wavelets
    compute the whole-image transform with per-step halos."""
    if color not in ("none", "rct", "ict"):
        raise ValueError(f"color must be none|rct|ict, got {color!r}")
    if wavelet == "cdf53":
        wavelet = "legall5.3"
    integer = is_integer_wavelet(wavelet)
    if color == "rct" and not integer:
        raise ValueError("rct is reversible — pair it with an integer wavelet")
    if color == "ict" and integer:
        raise ValueError("ict is lossy — pair it with a float wavelet")
    x = as_input(image, mesh)
    if color != "none" and (x.ndim < 3 or x.shape[-3] not in (3, 4)):
        raise ValueError("color transforms need planar (..., 3|4, H, W) input (RGB or RGBA)")
    _, ty, _, tx = tile_grid(mesh)
    unit = 1 << levels
    h_sem = x.shape[-2] + (-x.shape[-2] % unit)
    w_sem = x.shape[-1] + (-x.shape[-1] % unit)
    meta = dict(spec=spec, levels=levels, orig_shape=(x.shape[-2], x.shape[-1]), wavelet=wavelet, color=color,
                chroma_gain=chroma_gain)
    xl, (ph, pw) = _pad_for_mesh(x, levels, mesh, mode, constant, _color_step(color, chroma_gain))
    fused = wavelet in ("haar", "haar_int") or (
        wavelet == "legall5.3" and mesh53_aligned(h_sem, w_sem, ty, tx, levels))
    if fused:
        if wavelet == "haar" and xl.dtype != torch.uint8:
            xl = xl.to(torch.float32)
        elif wavelet != "haar" and xl.dtype != torch.uint8:
            xl = xl.to(torch.int32)  # integer lifting input (rct planes etc.)
        ll, dets = _fused_encode_local(xl, levels, spec, wavelet)
        # pair-local: the mesh alignment padding is cropped away (semantic
        # shapes, the single-device stream's); aligned 5/3 has none
        eh, ew = (h_sem, w_sem) if wavelet != "legall5.3" else (ph, pw)
        details = tuple(tuple(to_dtensor(b, mesh, (ph >> lvl, pw >> lvl), (eh >> lvl, ew >> lvl)) for b in bands)
                        for lvl, bands in enumerate(dets, start=1))
        ll = to_dtensor(ll, mesh, (ph >> levels, pw >> levels), (eh >> levels, ew >> levels))
        return CodeStream(ll=ll, details=details, layout="tiled", **meta)

    xl = xl.to(torch.int32) if integer else xl.to(torch.float32)
    ll, bands_local = _dwt_local(xl, levels, wavelet, mesh)
    details = []
    for lvl, bands in enumerate(bands_local, start=1):
        if integer:
            bands = tuple(b.to(torch.int16) for b in bands)
        else:
            bands = tuple(quantize_deadzone(b, s, torch.int16) for b, s in zip(bands, spec.band_steps(lvl)))
        details.append(tuple(to_dtensor(b, mesh, (ph >> lvl, pw >> lvl), (ph >> lvl, pw >> lvl)) for b in bands))
    # the halo-exchanged transform IS the whole-image (global) transform
    ll = to_dtensor(ll.to(torch.int32) if integer else ll, mesh, (ph >> levels, pw >> levels),
                    (ph >> levels, pw >> levels))
    return CodeStream(ll=ll, details=tuple(details), layout="global", **meta)


def _plain_codes(stream: CodeStream, ll, details) -> CodeStream:
    """``stream`` holding this rank's blocks ``ll``, ``details``, with maxshift
    ROI undone and integer R-D divisors widened back (both per code; a
    float stream keeps its divisors for :func:`_scaled_steps`)."""
    return _widen_div_int(_normalize_roi(dataclasses.replace(stream, ll=ll, details=tuple(details))))


def _finish_decode(stream: CodeStream, xl: torch.Tensor, mesh, padded: tuple[int, int], emit_u8: bool):
    """The decode tail on this rank's block: the inverse color rotation, the
    clip and cast where the kernel did not emit, the crop to the original
    dims (a DTensor)."""
    xl = _undo_color(stream, xl)
    if emit_u8 and xl.dtype not in (torch.uint8, torch.uint16):
        xl = _emit_native(stream, xl)
    return to_dtensor(xl, mesh, padded, stream.orig_shape)


def _fused_decode_local(local: CodeStream, emit_u8: bool, lh_out: int, lw_out: int):
    """This rank's inverse passes (K3 for haar, K7 for the integer
    wavelets) over ``local``, a stream of its blocks, coarse to fine."""
    levels, wavelet, details = local.levels, local.wavelet, local.details
    x, hi = local.ll, levels
    for k in reversed(_pass_sizes(levels)):
        lo = hi - k
        use = [tuple(contiguous_aligned(b) for b in details[i]) for i in range(lo, hi)]
        ch, cw = use[-1][0].shape[-2], use[-1][0].shape[-1]
        x = contiguous_aligned(x[..., :ch, :cw])
        last = emit_u8 and lo == 0
        if wavelet == "haar":
            steps = tuple(_scaled_steps(local, i + 1) for i in range(lo, hi))
            x = idwt_multilevel_dequant(x.to(torch.float32), use, steps, emit_u8=last)
        else:
            use = [tuple(b.to(torch.int16) for b in bands) for bands in use]
            x = idwt53_multilevel(x, use, k, emit_u8=last, filt=wavelet)
        hi = lo
    # drop the kernels' per-shard tile padding so the blocks abut at the
    # local semantic extent
    return x[..., :lh_out, :lw_out]


def tiled_decode(stream: CodeStream, *, mesh, emit_u8: bool = False):
    """Sharded inverse of :func:`tiled_encode` (a DTensor of the original
    dims). haar and haar_int streams, and mesh-aligned legall5.3 streams,
    decode per shard through K3/K7; 'global' streams run the halo inverse.
    A tile-local wide-wavelet stream whose tiles cannot align with this mesh
    decodes on every rank from the gathered stream (a replicated DTensor),
    exactly, as the reference decodes it on one device."""
    _, ty, _, tx = tile_grid(mesh)
    levels = stream.levels
    integer = is_integer_wavelet(stream.wavelet)
    wavelet = "legall5.3" if stream.wavelet == "cdf53" else stream.wavelet
    h_sem, w_sem = stream.ll.shape[-2] << levels, stream.ll.shape[-1] << levels
    fused = (stream.layout == "tiled" and stream.bit_depth == 8
             and (wavelet in ("haar", "haar_int")
                  or (wavelet == "legall5.3" and mesh53_aligned(h_sem, w_sem, ty, tx, levels))))
    if fused:
        # grow every band to the mesh-padded extent by its edge (pair-local
        # transforms put what padding makes only into padding rows, which
        # the final crop removes; aligned 5/3 needs no padding)
        unit = 1 << levels
        h_dec, w_dec = h_sem + (-h_sem % (ty * unit)), w_sem + (-w_sem % (tx * unit))

        def grown(b, lvl):
            src = as_input(b, mesh)
            return take_block(src, mesh, edge_map(b.shape[-2], h_dec >> lvl), edge_map(b.shape[-1], w_dec >> lvl))

        local = _plain_codes(stream, grown(stream.ll, levels),
                             [tuple(grown(b, lvl) for b in stream.details[lvl - 1]) for lvl in range(1, levels + 1)])
        u8_in = emit_u8 and stream.color == "none"
        xl = _fused_decode_local(dataclasses.replace(local, wavelet=wavelet), u8_in, h_dec // ty, w_dec // tx)
        return _finish_decode(stream, xl, mesh, (h_dec, w_dec), emit_u8)

    if stream.layout == "tiled" and stream.wavelet not in ("haar", "haar_int"):
        # tile-local geometry that cannot map onto this mesh: decode exactly
        # on every rank instead of decoding it wrong in parallel
        return replicated_dtensor(decode(stream, emit_u8=emit_u8), mesh)

    local = _plain_codes(stream, even_block(stream.ll, mesh),
                         [tuple(even_block(b, mesh) for b in bands) for bands in stream.details])
    details = []
    for lvl, bands in enumerate(local.details, start=1):
        if integer:
            details.append(tuple(b.to(torch.int32) for b in bands))
        else:
            details.append(tuple(dequantize_deadzone(b, s) for b, s in zip(bands, _scaled_steps(local, lvl))))
    xl = _idwt_local(local.ll.to(torch.int32 if integer else torch.float32), details, stream.wavelet, mesh)
    return _finish_decode(stream, xl, mesh, (xl.shape[-2] * ty, xl.shape[-1] * tx), emit_u8)

