"""The image codec (counterpart of ``wicca_tpu/codec/pipeline.py``):

* ``wavelet='haar'``: fused DWT + deadzone quantization (kernel K2) and
  fused dequantization + inverse DWT (K3), lossy;
* ``wavelet='legall5.3'`` (alias ``'cdf53'``) or ``'haar_int'``, optionally
  after the reversible color transform (``color='rct'``): the lossless
  JPEG2000-style path on tile-local integer lifting (K6/K7); ``decode``
  returns the input bit for bit;
* ``wavelet='bior4.4'``/``'cdf97'`` (CDF 9/7) or ``'db2'``, optionally after
  the irreversible color transform (``color='ict'``, with ``chroma_gain``):
  the lossy JPEG2000-style path on tile-local float lifting with the
  deadzone quantizer fused in (K8/K9);
* a registered wavelet, and every lifting wavelet at ``bit_depth`` 9-16:
  whole-image lifting (``layout='global'``) in plain PyTorch, as the
  reference leaves it to XLA; at high bit depth the codes are int32, and
  uint16 input roundtrips bit for bit on the integer wavelets.

``encode`` -> :class:`CodeStream`; ``decode`` -> reconstructed image,
cropped to the original dims; ``decode_at_level`` (resolution
scalability), ``decode_region`` (spatial random access) and
``icon_from_stream`` read only part of a stream. Every decode undoes
maxshift ROI coding (:mod:`wicca_tpu_torch.codec.roi`) first;
``with_metadata`` attaches application metadata, which decode ignores.

Plain 8-bit Haar on a card (``wavelet='haar'``, ``color='none'``, bit depth
8, uint8 or float32 input; on decode a stream without ROI coding or R-D
divisors, not a mesh stream) takes a launch plan: one per geometry and
setting, built on the first call and kept in a bounded LRU (64 each for
``encode`` and ``decode``). A plan holds the pass partition, every output's
shape and dtype and the kernels' packed step arrays, never a tensor: each
call checks its tensors once, allocates fresh outputs and queues the K2 or
K3 launches, so a stream or image a caller holds never changes under a
later call. Outputs, launch counts and refusals are those of the per-pass
code, which every other input keeps (the plain twins on the CPU, the
lifting wavelets, colour, ROI, R-D and mesh streams). Each call through a
plan counts ``codec.plan_hit`` or ``codec.plan_miss``
(:mod:`wicca_tpu_torch.utils.timing`).

Every level partition, shape and rounding step follows the JAX package, so
streams cross between the two (:mod:`wicca_tpu_torch.codec.interop`). The
float wavelets agree with it within the tolerance stated in
``tests/test_torch_codec_float.py``: the reference's XLA build contracts
some lifting products into fused multiply-adds, depending on the shape.
"""

from __future__ import annotations

import collections
import dataclasses
import threading

import numpy as np
import torch

from wicca_tpu_torch._device import as_tensor
from wicca_tpu_torch.comm import gather_stream
from wicca_tpu_torch.core.color import ict_fwd_codec, ict_inv_codec, rct_fwd_codec, rct_inv_codec
from wicca_tpu_torch.core.lifting import dwt2_level_lifting, idwt2_level_lifting, is_integer_wavelet, lifting_wavelets
from wicca_tpu_torch.core.pad import normalize_border_mode, pad_amounts, pad_to_multiple, unpad
from wicca_tpu_torch.core.quant import QuantSpec, dequantize_deadzone, quantize_deadzone
from wicca_tpu_torch.ops.dwt53_cuda import dwt53_multilevel, idwt53_multilevel
from wicca_tpu_torch.ops.dwt97_cuda import dwt97_multilevel_quant, idwt97_multilevel_dequant
from wicca_tpu_torch.ops.dwt_cuda import (
    _TILE_H,
    _TILE_W,
    DwtPass,
    IdwtPass,
    _band_steps3,
    _check_dwt,
    contiguous_aligned,
    dwt_multilevel_quant,
    idwt_multilevel_dequant,
    launch_on_card,
)
from wicca_tpu_torch.utils.timing import count, spanned

# wavelet -> filter of the tile-local lifting kernels: K6/K7, K8/K9
_INT_TILED = {"legall5.3": "legall5.3", "cdf53": "legall5.3", "haar_int": "haar_int"}
_FLOAT_TILED = {"bior4.4": "cdf97", "cdf97": "cdf97", "db2": "db2"}


def _pass_sizes(levels: int) -> list[int]:
    """Fine-side partition of a multi-level transform into fused passes of
    <= 3 levels (the encoder's grouping; decode mirrors it)."""
    sizes = []
    lvl = 0
    while lvl < levels:
        sizes.append(min(3, levels - lvl))
        lvl += sizes[-1]
    return sizes


def _pass_partition(levels: int) -> list[tuple[int, int]]:
    """``[(lo, hi)]`` fine -> coarse; a pass covers levels ``lo+1..hi``."""
    out, lo = [], 0
    for k in _pass_sizes(levels):
        out.append((lo, lo + k))
        lo += k
    return out


def _crop_semantic(ll, details, h_sem: int, w_sem: int, levels: int):
    """Keep each stored subband's semantic extent (h_sem, w_sem are the dims
    after the 2**levels padding). Valid for the pair-local transforms (haar,
    haar_int) only; wide wavelets keep their tile-padded geometry."""
    ll = ll[..., : h_sem >> levels, : w_sem >> levels]
    out = []
    for lvl, bands in enumerate(details, start=1):
        out.append(tuple(b[..., : h_sem >> lvl, : w_sem >> lvl] for b in bands))
    return ll, out


@dataclasses.dataclass(frozen=True)
class CodeStream:
    """Multi-level representation, with the fields of the JAX package's
    ``CodeStream``. ``details[k]`` = (lh, hl, hh) codes of level k+1 (finest
    first): int8/int16 deadzone codes for haar, int16 deadzone codes for the
    float wavelets, exact int16 coefficients for the integer wavelets, and
    int32 for every wavelet at ``bit_depth`` > 8. ``ll`` = coarse band,
    float32, or int32 for the integer wavelets. ``color`` records a channel
    decorrelation applied before the transform ('rct' reversible, 'ict'
    BT.601 with its chroma planes divided by ``chroma_gain``); ``layout``
    the transform geometry of wide wavelets ('tiled': independent (512,
    1024) tiles, as the fused kernels run; 'global': whole-image lifting).
    ``band_div`` holds the per-plane step divisors of R-D truncation (() =
    all 1)."""

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


def _encode_global(x: torch.Tensor, levels: int, spec: QuantSpec, wavelet: str, dtype: torch.dtype):
    """Whole-image lifting: exact int32 coefficients for the integer
    wavelets, deadzone codes of ``dtype`` for the float ones."""
    details = []
    if is_integer_wavelet(wavelet):
        ll = x.to(torch.int32)
        for _ in range(levels):
            ll, lh, hl, hh = dwt2_level_lifting(ll, wavelet)
            details.append((lh, hl, hh))
    else:
        ll = x.to(torch.float32)
        for lvl in range(1, levels + 1):
            ll, lh, hl, hh = dwt2_level_lifting(ll, wavelet)
            details.append(tuple(quantize_deadzone(b, s, dtype) for b, s in zip((lh, hl, hh), spec.band_steps(lvl))))
    return ll, details


# ---------------------------------------------------------------------------
# Launch plans of the fused 8-bit Haar path
# ---------------------------------------------------------------------------

# device types whose tensors take the launch plans, and what launches a plan there
_PLAN_LAUNCH = {"cuda": launch_on_card}
_MISSING = object()


class _PlanCache:
    """The launch plans of the last ``size`` geometries (least recently used
    out), built by ``build(*key)`` on a miss. A plan holds shapes, dtypes
    and packed launch arguments, never a tensor. ``build`` returns None for
    a geometry the plan path does not take; that is kept too, and counts as
    neither a hit nor a miss."""

    def __init__(self, build, size: int = 64):
        self._build, self._size = build, size
        self._plans: collections.OrderedDict = collections.OrderedDict()
        self._lock = threading.Lock()

    def get(self, key):
        with self._lock:
            plan = self._plans.get(key, _MISSING)
            if plan is not _MISSING:
                self._plans.move_to_end(key)
        if plan is _MISSING:
            plan = self._build(*key)
            with self._lock:
                self._plans[key] = plan
                if len(self._plans) > self._size:
                    self._plans.popitem(last=False)
            if plan is not None:
                count("codec.plan_miss", 1)
        elif plan is not None:
            count("codec.plan_hit", 1)
        return plan

    def clear(self) -> None:
        with self._lock:
            self._plans.clear()


class _EncodePlan:
    """K2's launches for one input geometry and setting: whether the input
    needs padding to ``2**levels``, and each pass's packed launch. The
    checks the pass code makes run here, once, with the same messages."""

    __slots__ = ("pad", "passes")

    def __init__(self, shape, dtype, index, levels, spec, mode):  # the device index only keys the plan
        if levels < 1:
            raise ValueError("levels must be >= 1")
        normalize_border_mode(mode)
        dr, dc = pad_amounts(shape[-2], shape[-1], 1 << levels)
        self.pad = bool(dr or dc)
        shape, lvl, self.passes = tuple(shape[:-2]) + (shape[-2] + dr, shape[-1] + dc), 0, []
        for k in _pass_sizes(levels):
            steps = tuple(spec.band_steps(lvl + i + 1) for i in range(k))
            _check_dwt(torch.empty(shape, dtype=dtype, device="meta"), steps)
            self.passes.append(DwtPass(shape, dtype, _band_steps3(steps), stack=True))
            shape, dtype, lvl = self.passes[-1].ll_shape, torch.float32, lvl + k

    def launch(self, lib, x: torch.Tensor, stream: int):
        """The passes fine to coarse on the padded, checked input: every
        pass's LL and bands already have their semantic extents."""
        details = []
        for p in self.passes:
            x, dets = p.launch(lib, x, stream)
            details.extend(dets)
        return x, details


class _DecodePlan:
    """K3's launches for one stream geometry and setting: each pass's levels
    ``(lo, hi)`` and packed launch, coarse to fine, and whether the result
    is cropped to the original dims."""

    __slots__ = ("passes", "crop")

    def __init__(self, passes: list, crop: bool):
        self.passes, self.crop = passes, crop

    def launch(self, lib, ll: torch.Tensor, details, stream: int) -> torch.Tensor:
        for lo, hi, p in self.passes:
            ll = p.launch(lib, ll, details[lo:hi], stream)
        return ll


def _decode_plan(ll_sig, band_sigs, levels, spec, emit_u8, recon_offset, orig_shape):
    """The plan of a stream's geometry (signatures ``(shape, dtype, device
    index)``), or None unless the stream is laid out as the encoder writes
    it: a float32 LL, each level's three bands of one code dtype at twice
    the next coarser extent, all on one device. Any other stream takes the
    pass code, which crops, casts or refuses it as it always has."""
    shape, dtype, index = ll_sig
    if dtype != torch.float32 or len(shape) < 2 or 0 in shape or levels < 1 or len(band_sigs) != levels:
        return None
    lead, ch, cw = tuple(shape[:-2]), shape[-2], shape[-1]
    codes = []
    for lvl, sigs in enumerate(band_sigs, start=1):
        if len(sigs) != 3:
            return None
        want = (lead + (ch << (levels - lvl), cw << (levels - lvl)), sigs[0][1], index)
        if want[1] not in (torch.int8, torch.int16) or any(s != want for s in sigs):
            return None
        codes.append(want[1])
    passes = []
    for lo, hi in reversed(_pass_partition(levels)):
        steps = _band_steps3(tuple(spec.band_steps(lvl + 1) for lvl in range(lo, hi)))
        pshape = lead + (ch << (levels - hi), cw << (levels - hi))
        passes.append((lo, hi, IdwtPass(pshape, codes[lo:hi], steps, bool(emit_u8) and lo == 0, recon_offset)))
    return _DecodePlan(passes, orig_shape[0] < ch << levels or orig_shape[1] < cw << levels)


_ENCODE_PLANS = _PlanCache(_EncodePlan)
_DECODE_PLANS = _PlanCache(_decode_plan)


def _sig(t: torch.Tensor):
    return t.shape, t.dtype, t.get_device()


def _encode_planned(x: torch.Tensor, levels, spec, mode, constant, chroma_gain) -> CodeStream:
    """``encode`` of an 8-bit Haar image without color transform on a
    device with launch plans: the plan of the input's geometry, then only
    the padding (where the plan says so), one check of the input (copied
    where it is not contiguous and 16-byte aligned) and the launches."""
    plan = _ENCODE_PLANS.get((x.shape, x.dtype, x.get_device(), levels, spec, mode))
    orig = (x.shape[-2], x.shape[-1])
    if plan.pad:
        x = pad_to_multiple(x, 1 << levels, mode=mode, constant=constant)
    x = contiguous_aligned(x)
    ll, details = _PLAN_LAUNCH[x.device.type](x.get_device(), plan.launch, x)
    return CodeStream(ll=ll, details=tuple(details), spec=spec, levels=levels, orig_shape=orig,
                      chroma_gain=chroma_gain)


def _decode_planned(stream: CodeStream, emit_u8, recon_offset) -> torch.Tensor | None:
    """``decode`` of a plain 8-bit Haar stream on a device with launch plans
    (no color transform, ROI or R-D divisors, not a mesh stream, laid out as
    the encoder writes it): its tensors checked once, copied where they are
    not contiguous and 16-byte aligned, and the launches. None for any other
    stream."""
    ll = stream.ll
    if (stream.wavelet != "haar" or stream.bit_depth != 8 or stream.color != "none" or stream.roi_shift
            or stream.band_div or type(ll) is not torch.Tensor or ll.device.type not in _PLAN_LAUNCH):
        return None
    sigs = tuple(tuple(map(_sig, bands)) for bands in stream.details)
    plan = _DECODE_PLANS.get((_sig(ll), sigs, stream.levels, stream.spec, emit_u8, recon_offset, stream.orig_shape))
    if plan is None:
        return None
    details = [tuple(map(contiguous_aligned, bands)) for bands in stream.details]
    x = _PLAN_LAUNCH[ll.device.type](ll.get_device(), plan.launch, contiguous_aligned(ll), details)
    return unpad(x, *stream.orig_shape) if plan.crop else x


@spanned("codec.encode")
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
    """Planar ``(..., H, W)`` image -> :class:`CodeStream`.

    A tensor is encoded where it lies; a numpy array on ``device`` (CUDA
    unless the caller says otherwise). ``wavelet='haar'``: uint8 input stays
    uint8 into the first fused pass (integer-exact early levels), any other
    dtype is cast to float32. Integer wavelets (``'legall5.3'``/``'cdf53'``,
    ``'haar_int'``) make a lossless stream: ``spec`` is ignored, details are
    exact int16, and :func:`decode` returns the input bit for bit. The float
    wavelets ``'bior4.4'``/``'cdf97'`` and ``'db2'`` run fused tile-local
    passes with int16 codes; any other registered wavelet runs whole-image
    lifting.

    ``color='rct'`` (integer wavelets, planar RGB or RGBA; alpha is carried
    through) applies the reversible color transform first; ``color='ict'``
    (float wavelets) the BT.601 rotation, with the chroma planes quantized
    ``chroma_gain`` times coarser. ``bit_depth`` (default: 16 for uint16
    input, else 8) above 8 takes the whole-image lifting path with int32
    codes; ``decode(emit_u8=True)`` then emits uint16 clipped to
    ``2**bit_depth - 1``.

    Plain 8-bit Haar of a uint8 or float32 tensor on a card takes the launch
    plan of its geometry (see the module docstring): the same stream, with
    only the padding, one check of the input and the two K2 launches per
    call."""
    x = as_tensor(image, device)
    if (wavelet == "haar" and color == "none" and bit_depth in (None, 8) and type(x) is torch.Tensor
            and x.device.type in _PLAN_LAUNCH and x.dtype in (torch.uint8, torch.float32)):
        return _encode_planned(x, levels, spec, mode, constant, chroma_gain)
    if bit_depth is None:
        bit_depth = 16 if x.dtype == torch.uint16 else 8
    if x.dtype == torch.uint16:  # few ops take uint16; int32 holds every sample
        x = x.to(torch.int32)
    if not 8 <= bit_depth <= 16:
        raise ValueError(f"bit_depth must be in [8, 16], got {bit_depth}")
    if color not in ("none", "rct", "ict"):
        raise ValueError(f"color must be none|rct|ict, got {color!r}")
    if color != "none" and (x.ndim < 3 or x.shape[-3] not in (3, 4)):
        raise ValueError("color transforms need planar (..., 3|4, H, W) input (RGB or RGBA)")
    if color == "rct" and not is_integer_wavelet(wavelet):
        raise ValueError("rct is reversible — pair it with an integer wavelet")
    if color == "ict" and is_integer_wavelet(wavelet):
        raise ValueError("ict is lossy — pair it with a float wavelet")
    if levels < 1:
        raise ValueError("levels must be >= 1")
    if wavelet != "haar" and wavelet not in lifting_wavelets():
        raise ValueError(f"Unknown wavelet {wavelet!r}; have {sorted(('haar',) + lifting_wavelets())}")
    if bit_depth != 8 and wavelet not in lifting_wavelets():
        raise ValueError(f"bit_depth {bit_depth} needs a lifting wavelet "
                         f"({', '.join(sorted(lifting_wavelets()))}); for Haar use 'haar_int'")
    if wavelet == "cdf53":  # stored under its canonical name
        wavelet = "legall5.3"
    orig = (x.shape[-2], x.shape[-1])
    x = pad_to_multiple(x, 1 << levels, mode=mode, constant=constant)
    # the tiled kernels fold the color transform into their first level:
    # the ICT into K8's, the RCT into K6's
    fold = bit_depth == 8 and ((color == "ict" and wavelet in _FLOAT_TILED)
                               or (color == "rct" and wavelet in _INT_TILED))
    if color == "rct" and not fold:
        x = rct_fwd_codec(x)  # alpha bypasses the rotation
    elif color == "ict" and not fold:
        x = ict_fwd_codec(x, chroma_gain)
    h_sem, w_sem = x.shape[-2], x.shape[-1]
    layout = "tiled"
    if bit_depth != 8:
        layout = "global"
        ll, details = _encode_global(x, levels, spec, wavelet, torch.int32)
    elif wavelet == "haar" or wavelet in _INT_TILED or wavelet in _FLOAT_TILED:
        if wavelet == "haar" and x.dtype != torch.uint8:
            x = x.to(torch.float32)
        ll, details, lvl = x, [], 0
        for k in _pass_sizes(levels):
            steps = tuple(spec.band_steps(lvl + i + 1) for i in range(k))
            if wavelet in ("haar", "haar_int"):  # pair-local: each pass starts from the semantic extent
                ll = ll[..., : h_sem >> lvl, : w_sem >> lvl]
            # the wide wavelets keep the tile-padded LL of the previous pass
            if wavelet == "haar":
                ll, dets = dwt_multilevel_quant(contiguous_aligned(ll), steps)
            elif wavelet in _FLOAT_TILED:
                ll, dets = dwt97_multilevel_quant(contiguous_aligned(ll), steps, filt=_FLOAT_TILED[wavelet],
                                                  color="ict" if fold and lvl == 0 else "none",
                                                  chroma_gain=chroma_gain)
            else:
                ll, dets = dwt53_multilevel(contiguous_aligned(ll), k, filt=wavelet,
                                            color="rct" if fold and lvl == 0 else "none")
            details.extend(dets)
            lvl += k
        if wavelet in ("haar", "haar_int"):
            ll, details = _crop_semantic(ll, details, h_sem, w_sem, levels)
    else:
        layout = "global"
        ll, details = _encode_global(x, levels, spec, wavelet, torch.int16)
    return CodeStream(
        ll=ll, details=tuple(details), spec=spec, levels=levels, orig_shape=orig,
        wavelet=wavelet, color=color, chroma_gain=chroma_gain, layout=layout, bit_depth=bit_depth,
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


def _widen_div_int(stream: CodeStream) -> CodeStream:
    """Integer-wavelet streams with R-D divisors: re-widen codes to bin
    midpoints (sign * (|c| * d + d // 2), 0 stays 0) so the exact integer
    lifting inverse applies unchanged. No-op otherwise."""
    if not stream.band_div or not is_integer_wavelet(stream.wavelet):
        return stream

    def widen(b, d):
        if d == 1:
            return b
        bi = b.to(torch.int32)
        w = torch.sign(bi) * torch.clamp(bi.abs() * d + d // 2, max=torch.iinfo(b.dtype).max)
        return w.to(b.dtype)

    details = tuple(
        tuple(widen(b, d) for b, d in zip(bands, stream.band_div[lvl * 3 : lvl * 3 + 3]))
        for lvl, bands in enumerate(stream.details)
    )
    return dataclasses.replace(stream, details=details, band_div=())


def _normalize_roi(stream: CodeStream) -> CodeStream:
    """Undo maxshift ROI scaling (:mod:`wicca_tpu_torch.codec.roi`): codes
    with ``|c| >= 2**roi_shift`` are ROI (exact ``>> roi_shift``), the rest
    background (midpoint ``<< bg_shift``). Returns plain deadzone codes in
    the path's native dtype (int8 haar, int16 otherwise, int32 at bit depths
    other than 8), where they lie; no-op for streams without ROI."""
    if not stream.roi_shift:
        return stream
    s, b = stream.roi_shift, stream.bg_shift
    dt = torch.int32 if stream.bit_depth != 8 else (torch.int8 if stream.wavelet == "haar" else torch.int16)

    def un(c):
        v = c.to(torch.int32)
        m, sg = v.abs(), torch.sign(v)
        bg = sg * ((m << b) + (1 << (b - 1))) if b else v
        return torch.where(m >= (1 << s), sg * (m >> s), bg).to(dt)

    details = tuple(tuple(un(band) for band in bands) for bands in stream.details)
    return dataclasses.replace(stream, details=details, roi_shift=0, bg_shift=0)


def _fused(stream: CodeStream) -> bool:
    """Whether the fused pass kernels decode the stream: the 8-bit haar and
    haar_int streams (pair-local, so either layout), and the 8-bit tiled
    5/3 and float-wavelet streams."""
    if stream.bit_depth != 8:
        return False
    return stream.wavelet in ("haar", "haar_int") or (
        stream.layout == "tiled" and (stream.wavelet in _INT_TILED or stream.wavelet in _FLOAT_TILED))


def _folds_color(stream: CodeStream, target_level: int) -> bool:
    """Whether the inverse passes down to ``target_level`` undo the color
    transform themselves: the ICT of 8-bit tiled float-wavelet streams, in
    the last launch of K9, and the RCT of 8-bit integer-wavelet streams, in
    the last launch of K7."""
    return _fused(stream) and target_level < stream.levels and (
        (stream.color == "ict" and stream.wavelet in _FLOAT_TILED)
        or (stream.color == "rct" and stream.wavelet in _INT_TILED))


def _k7_bands(stream: CodeStream, bands):
    """K7 reads int16 details. A layer prefix of a lossless container (and
    nothing else) holds its widened codes as int32; an 8-bit stream's
    details fit int16 (the encoder stores them so), so they are cast."""
    if stream.wavelet not in _INT_TILED:
        return bands
    return tuple(b.to(torch.int16) for b in bands)


def _inverse_passes(stream: CodeStream, target_level: int, emit_u8: bool, recon_offset: float):
    """The fused inverse passes, coarse to fine, down to ``target_level``.
    A pass that crosses the target inverts only its coarse part; for the
    lifting kernels ``orig_k`` then keeps the encoder's tile clamps.
    ``emit_u8`` clips and casts inside the pass that reaches the target,
    which also undoes the color transform where :func:`_folds_color` says
    so."""
    color = stream.color if _folds_color(stream, target_level) else "none"
    x = stream.ll
    hi = stream.levels
    for k in reversed(_pass_sizes(stream.levels)):
        if hi <= target_level:
            break
        start = max(hi - k, target_level)
        dets = [tuple(contiguous_aligned(b) for b in _k7_bands(stream, stream.details[i])) for i in range(start, hi)]
        steps = tuple(_scaled_steps(stream, i + 1) for i in range(start, hi))
        ch, cw = dets[-1][0].shape[-2], dets[-1][0].shape[-1]
        x = contiguous_aligned(x[..., :ch, :cw])
        last = start == target_level
        u8 = emit_u8 and last
        if stream.wavelet == "haar":
            x = idwt_multilevel_dequant(x.to(torch.float32), dets, steps, emit_u8=u8, recon_offset=recon_offset)
        elif stream.wavelet in _FLOAT_TILED:
            x = idwt97_multilevel_dequant(x, dets, steps, emit_u8=u8, orig_k=k, filt=_FLOAT_TILED[stream.wavelet],
                                          recon_offset=recon_offset, color=color if last else "none",
                                          chroma_gain=stream.chroma_gain)
        else:
            x = idwt53_multilevel(x, dets, len(dets), emit_u8=u8, orig_k=k, filt=_INT_TILED[stream.wavelet],
                                  color=color if last else "none")
        hi = start
    return x


def _inverse_global(stream: CodeStream, target_level: int, recon_offset: float) -> torch.Tensor:
    """Whole-image lifting inverse (global-layout and high-bit-depth
    streams), plain PyTorch as in the reference, which leaves it to XLA:
    exact int32 for the integer wavelets, dequantized float32 otherwise."""
    exact = is_integer_wavelet(stream.wavelet)
    x = stream.ll.to(torch.int32) if exact else stream.ll
    for lvl in range(stream.levels, target_level, -1):
        bands = stream.details[lvl - 1]
        if exact:
            bands = tuple(b.to(torch.int32) for b in bands)
        else:
            bands = tuple(dequantize_deadzone(b, s, offset=recon_offset)
                          for b, s in zip(bands, _scaled_steps(stream, lvl)))
        x = x[..., : bands[0].shape[-2], : bands[0].shape[-1]]
        x = idwt2_level_lifting(x, *bands, stream.wavelet)
    return x


def _inverse(stream: CodeStream, target_level: int, emit_u8: bool, recon_offset: float) -> torch.Tensor:
    if _fused(stream):
        return _inverse_passes(stream, target_level, emit_u8, recon_offset)
    return _inverse_global(stream, target_level, recon_offset)


def _undo_color(stream: CodeStream, x: torch.Tensor) -> torch.Tensor:
    if stream.color == "none":
        return x
    if stream.color == "rct":
        return rct_inv_codec(x)  # alpha was never rotated
    return ict_inv_codec(x, stream.chroma_gain)


def _emit_native(stream: CodeStream, x: torch.Tensor) -> torch.Tensor:
    """Clip and cast to the stream's native unsigned sample type: uint8, or
    uint16 clipped to ``2**bit_depth - 1`` for high-bit-depth streams."""
    if stream.bit_depth <= 8:
        return torch.clamp(x, 0, 255).to(torch.uint8)
    # through int32: few ops take uint16, and the float cast truncates as JAX's does
    return torch.clamp(x, 0, (1 << stream.bit_depth) - 1).to(torch.int32).to(torch.uint16)


@spanned("codec.decode")
def decode(stream: CodeStream, emit_u8: bool = False, recon_offset: float = 0.5) -> torch.Tensor:
    """CodeStream -> reconstructed image (original dims): float32, or int32
    for the integer wavelets; with ``emit_u8`` the stream's native unsigned
    type (uint8, clipped and cast inside the finest fused pass when no color
    transform follows or the pass undoes it itself; uint16 for
    high-bit-depth streams). ``recon_offset``
    is the deadzone reconstruction point of lossy codes as a fraction of the
    bin (0.5 = midpoint). Runs where the stream's tensors lie; a mesh
    stream is gathered first (:func:`~wicca_tpu_torch.comm.gather_stream`).
    A plain 8-bit Haar stream on a card, laid out as :func:`encode` writes
    it, takes the launch plan of its geometry (see the module docstring)."""
    planned = _decode_planned(stream, emit_u8, recon_offset)
    if planned is not None:
        return planned
    stream = _widen_div_int(_normalize_roi(gather_stream(stream)))
    folded = _folds_color(stream, 0)
    x = _inverse(stream, 0, emit_u8 and (stream.color == "none" or folded), recon_offset)
    if not folded:
        x = _undo_color(stream, x)
    if emit_u8 and x.dtype != torch.uint8:  # not already cast inside the finest pass
        x = _emit_native(stream, x)
    return unpad(x, *stream.orig_shape)


def decode_at_level(stream: CodeStream, target_level: int, emit_u8: bool = False,
                    recon_offset: float = 0.5) -> torch.Tensor:
    """Progressive decode at 1/2**target_level resolution from the coarse
    subbands only (finer detail planes are never read). ``target_level=0``
    equals :func:`decode`; ``target_level=levels`` returns the LL band
    itself. Output dims are the original dims divided by 2**target_level
    (ceil)."""
    if not 0 <= target_level <= stream.levels:
        raise ValueError(f"target_level must be in [0, {stream.levels}]")
    if target_level == 0:
        return decode(stream, emit_u8=emit_u8, recon_offset=recon_offset)
    stream = _widen_div_int(_normalize_roi(gather_stream(stream)))
    h, w = stream.orig_shape
    folded = _folds_color(stream, target_level)
    x = _inverse(stream, target_level, emit_u8 and folded, recon_offset)
    if not folded:
        x = _undo_color(stream, x)
    x = unpad(x, -(-h // (1 << target_level)), -(-w // (1 << target_level)))
    return _emit_native(stream, x) if emit_u8 and x.dtype != torch.uint8 else x


def icon_from_stream(stream: CodeStream) -> torch.Tensor:
    """Native-type icon straight from the coarse band (free at decode time;
    uint8, or uint16 for high-bit-depth streams); a color-transformed
    stream's LL gets the inverse rotation first. ROI coding never touches
    the LL, so an ROI stream gives its plain stream's icon."""
    stream = gather_stream(stream)
    return _emit_native(stream, _undo_color(stream, stream.ll))


def with_metadata(stream: CodeStream, meta: dict) -> CodeStream:
    """Attach application metadata (EXIF dump, ICC profile, notes: the
    JPEG2000 XML/UUID box analog). Values may be str (stored utf-8) or
    bytes; ``{}`` clears. Serialized in the WCT8 header block, kept by
    save/load and transcode, ignored by decode."""
    items = tuple((str(k), v.encode("utf-8") if isinstance(v, str) else bytes(v)) for k, v in meta.items())
    return dataclasses.replace(stream, metadata=items)


def region_plan(stream: CodeStream, row0: int, row1: int, col0: int, col1: int):
    """Per-pass windows of a tiled wide-wavelet region decode:
    ``[(lo, hi, a0, a1, b0, b1)]`` coarse -> fine, the window of the pass
    covering levels ``lo+1..hi`` in its output space (the 1/2**lo grid),
    aligned to the encoder's (512, 1024) tile grid there and clamped to the
    stored (tile-padded) extent."""
    plan = []
    for lo, hi in reversed(_pass_partition(stream.levels)):
        band = stream.details[lo][0]  # level lo+1 band = padded extent / 2
        eh, ew = band.shape[-2] * 2, band.shape[-1] * 2
        a0 = (row0 >> lo) // _TILE_H * _TILE_H
        b0 = (col0 >> lo) // _TILE_W * _TILE_W
        a1 = min(-(-(-(-row1 // (1 << lo))) // _TILE_H) * _TILE_H, eh)
        b1 = min(-(-(-(-col1 // (1 << lo))) // _TILE_W) * _TILE_W, ew)
        plan.append((lo, hi, a0, a1, b0, b1))
    return plan


def region_coefficient_fraction(stream: CodeStream, row0, row1, col0, col1) -> float:
    """Fraction of stored detail coefficients a tiled wide-wavelet region
    decode touches."""
    touched = total = 0
    for lo, hi, a0, a1, b0, b1 in region_plan(stream, row0, row1, col0, col1):
        for lvl in range(lo + 1, hi + 1):
            s = lvl - lo
            for b in stream.details[lvl - 1]:
                total += b.shape[-2] * b.shape[-1]
                touched += ((a1 >> s) - (a0 >> s)) * ((b1 >> s) - (b0 >> s))
    return touched / max(total, 1)


def _decode_region_tiled(stream: CodeStream, row0, row1, col0, col1, emit_u8: bool,
                         recon_offset: float) -> torch.Tensor:
    """Hierarchical region decode of a tiled 5/3 or float-wavelet stream:
    the inverse pass cascade coarse -> fine, each pass on its tile-aligned
    window only (independent tiles), so the result equals the same crop of
    :func:`decode`."""
    stream = _widen_div_int(_normalize_roi(stream))
    x = None
    pa0 = pb0 = 0
    for lo, hi, a0, a1, b0, b1 in region_plan(stream, row0, row1, col0, col1):
        k = hi - lo
        dets = [
            tuple(contiguous_aligned(b[..., a0 >> s : a1 >> s, b0 >> s : b1 >> s])
                  for b in _k7_bands(stream, stream.details[lvl - 1]))
            for lvl, s in ((lvl, lvl - lo) for lvl in range(lo + 1, hi + 1))
        ]
        if x is None:
            ll = stream.ll[..., a0 >> k : a1 >> k, b0 >> k : b1 >> k]
        else:
            ll = x[..., (a0 >> k) - pa0 : (a1 >> k) - pa0, (b0 >> k) - pb0 : (b1 >> k) - pb0]
        if stream.wavelet in _FLOAT_TILED:
            steps = tuple(_scaled_steps(stream, i + 1) for i in range(lo, hi))
            x = idwt97_multilevel_dequant(contiguous_aligned(ll), dets, steps, filt=_FLOAT_TILED[stream.wavelet],
                                          recon_offset=recon_offset)
        else:
            x = idwt53_multilevel(contiguous_aligned(ll), dets, k, filt="legall5.3")
        pa0, pb0 = a0, b0
    x = _undo_color(stream, x)
    if emit_u8:
        x = _emit_native(stream, x)
    return x[..., row0 - pa0 : row1 - pa0, col0 - pb0 : col1 - pb0]


def decode_region(stream: CodeStream, row0: int, row1: int, col0: int, col1: int, emit_u8: bool = False,
                  recon_offset: float = 0.5) -> torch.Tensor:
    """Spatial random access: pixels ``[row0:row1, col0:col1)``, exactly the
    same crop of :func:`decode`, from the coefficients that reach them.
    haar/haar_int slice at ``2**levels`` alignment; tiled 5/3 and float
    wavelets run the pass cascade on tile-aligned windows
    (:func:`region_plan`); global-layout streams add a ``16 * 2**levels``
    halo that covers the inverse cascade (exact for the integer wavelets;
    the float ones match the full decode to float32 rounding)."""
    stream = gather_stream(stream)
    H, W = stream.orig_shape
    if not (0 <= row0 < row1 <= H and 0 <= col0 < col1 <= W):
        raise ValueError(f"region [{row0}:{row1}, {col0}:{col1}) outside image {(H, W)}")
    lv = stream.levels
    align = 1 << lv
    margin = 0
    if stream.wavelet not in ("haar", "haar_int"):
        if stream.layout == "tiled":
            return _decode_region_tiled(stream, row0, row1, col0, col1, emit_u8, recon_offset)
        margin = 16 << lv
    r0 = max(0, row0 - margin) // align * align
    c0 = max(0, col0 - margin) // align * align
    r1 = -(-(row1 + margin) // align) * align
    c1 = -(-(col1 + margin) // align) * align
    details = tuple(
        tuple(b[..., r0 >> lvl : r1 >> lvl, c0 >> lvl : c1 >> lvl] for b in stream.details[lvl - 1])
        for lvl in range(1, lv + 1)
    )
    sub = dataclasses.replace(
        stream, ll=stream.ll[..., r0 >> lv : r1 >> lv, c0 >> lv : c1 >> lv], details=details,
        orig_shape=(min(r1, H) - r0, min(c1, W) - c0),
    )
    out = decode(sub, emit_u8=emit_u8, recon_offset=recon_offset)
    return out[..., row0 - r0 : row1 - r0, col0 - c0 : col1 - c0]


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
