"""Rate-distortion tooling (counterpart of ``wicca_tpu/codec/rd.py``).

The first half sweeps quantization steps and reports (bits per pixel, PSNR,
SSIM, MS-SSIM) operating points, and meets a rate or quality target by a
bisection over a geometric step grid (:func:`encode_to_bpp`,
:func:`encode_to_psnr`). Rate is the order-0 Shannon bound of the codes, or
the real container size.

The second half is post-compression rate-distortion optimization (the PCRD
half of EBCOT): encode once at a fine step, :func:`measure` per-plane (rate,
distortion) tables over a ladder of integer re-quantization divisors,
:func:`allocate` picks each plane's divisor by a Lagrangian sweep over the
convex hulls, and :func:`truncate` returns the stream whose WCT9
``band_div`` table tells the decoder to dequantize each plane at
``step * div``.

Encodes and decodes run where the image or stream lies (a numpy image on
``device``, CUDA unless the caller passes ``device='cpu'``); the tables are
host work on codes copied to the host once. :func:`synthesis_gains` sends
impulses through the port's own inverse transforms on the CPU.
"""

from __future__ import annotations

import dataclasses
import functools
import heapq

import numpy as np
import torch

from wicca_tpu_torch._device import as_tensor
from wicca_tpu_torch.codec.container import _encode_plane, host_arrays, serialize
from wicca_tpu_torch.codec.pipeline import CodeStream, decode, encode, estimated_entropy_bytes
from wicca_tpu_torch.core.haar import Pyramid, idwt2
from wicca_tpu_torch.core.lifting import idwt2_level_lifting, is_integer_wavelet
from wicca_tpu_torch.core.metrics import ms_ssim, psnr, ssim
from wicca_tpu_torch.core.quant import QuantSpec


def rd_point(image, step: float, levels: int = 5, wavelet: str = "haar", actual_bytes: bool = False,
             color: str = "none", chroma_gain: float = 1.0, hh_gain: float = 1.0, device=None) -> dict:
    """One operating point: encode at ``step``, measure rate and distortion
    (PSNR, SSIM, MS-SSIM; ``bpp_actual`` from the container with
    ``actual_bytes``)."""
    x = as_tensor(image, device)
    stream = encode(x, levels=levels, spec=QuantSpec(base_step=step, hh_gain=hh_gain), wavelet=wavelet,
                    color=color, chroma_gain=chroma_gain)
    rec = decode(stream)
    xf = x.to(torch.float32)
    n_px = x.numel()
    point = {
        "step": step,
        "psnr_db": round(float(psnr(rec, xf)), 3),
        "ssim": round(float(ssim(rec, xf)), 4),
        "ms_ssim": round(float(ms_ssim(rec, xf)), 4),
        "bpp_entropy": round(8.0 * estimated_entropy_bytes(stream) / n_px, 4),
    }
    if actual_bytes:
        point["bpp_actual"] = round(8.0 * len(serialize(stream)) / n_px, 4)
    return point


def rd_curve(image, steps=(0.5, 1.0, 2.0, 4.0, 8.0), levels: int = 5, wavelet: str = "haar",
             actual_bytes: bool = False, color: str = "none", chroma_gain: float = 1.0, hh_gain: float = 1.0,
             device=None) -> list[dict]:
    """R-D sweep over quantization steps, in the given step order."""
    x = as_tensor(image, device)
    return [rd_point(x, s, levels, wavelet, actual_bytes, color, chroma_gain, hh_gain) for s in steps]


# the searches walk a geometric step grid, 4 steps per octave over [0.125, 512]
_GRID_BASE = 0.125
_GRID_MAX_IDX = 48


def _grid_step(i: int) -> float:
    return _GRID_BASE * 2.0 ** (i / 4.0)


def _check_rate_controllable(wavelet: str):
    if is_integer_wavelet(wavelet):
        raise ValueError(f"{wavelet!r} is lossless — its rate is not step-controllable")


def encode_to_bpp(image, target_bpp: float, levels: int = 5, wavelet: str = "haar", color: str = "none",
                  chroma_gain: float = 1.0, rate: str = "entropy", codec: str = "auto", device=None) -> tuple:
    """Encode at the finest grid step whose rate is <= ``target_bpp``
    (``rate='entropy'``: the order-0 estimate; ``'actual'``: container
    bytes). Returns ``(stream, info)`` with the step, the bpp reached and
    the probe count; rate falls with the step, so this is a bisection."""
    if rate not in ("entropy", "actual"):
        raise ValueError(f"rate must be entropy|actual, got {rate!r}")
    _check_rate_controllable(wavelet)
    x = as_tensor(image, device)
    n_px = x.numel()

    def probe(i: int):
        stream = encode(x, levels=levels, spec=QuantSpec(base_step=_grid_step(i)), wavelet=wavelet, color=color,
                        chroma_gain=chroma_gain)
        if rate == "actual":
            return stream, 8.0 * len(serialize(stream, codec=codec)) / n_px
        return stream, 8.0 * estimated_entropy_bytes(stream) / n_px

    probes = 0
    lo, hi = 0, _GRID_MAX_IDX  # bpp falls as i grows
    best = None
    while lo <= hi:
        mid = (lo + hi) // 2
        stream, bpp = probe(mid)
        probes += 1
        if bpp <= target_bpp:
            best = (mid, stream, bpp)
            hi = mid - 1  # try finer
        else:
            lo = mid + 1
    if best is None:  # even the coarsest step overshoots
        stream, bpp = probe(_GRID_MAX_IDX)
        probes += 1
        best = (_GRID_MAX_IDX, stream, bpp)
    i, stream, bpp = best
    info = {"step": _grid_step(i), "bpp": round(bpp, 4), "target_bpp": target_bpp, "rate": rate, "probes": probes,
            "met": bpp <= target_bpp}
    return stream, info


def encode_to_psnr(image, target_db: float, levels: int = 5, wavelet: str = "haar", color: str = "none",
                   chroma_gain: float = 1.0, device=None) -> tuple:
    """Encode at the coarsest grid step whose reconstruction PSNR is >=
    ``target_db``. Returns ``(stream, info)``."""
    _check_rate_controllable(wavelet)
    x = as_tensor(image, device)
    xf = x.to(torch.float32)

    def probe(i: int):
        stream = encode(x, levels=levels, spec=QuantSpec(base_step=_grid_step(i)), wavelet=wavelet, color=color,
                        chroma_gain=chroma_gain)
        return stream, float(psnr(decode(stream), xf))

    probes = 0
    lo, hi = 0, _GRID_MAX_IDX  # PSNR falls as i grows
    best = None
    while lo <= hi:
        mid = (lo + hi) // 2
        stream, db = probe(mid)
        probes += 1
        if db >= target_db:
            best = (mid, stream, db)
            lo = mid + 1  # try coarser
        else:
            hi = mid - 1
    if best is None:  # even the finest step misses the bar
        stream, db = probe(0)
        probes += 1
        best = (0, stream, db)
    i, stream, db = best
    info = {"step": _grid_step(i), "psnr_db": round(db, 3), "target_db": target_db, "probes": probes,
            "met": db >= target_db}
    return stream, info


def plot_rd_curve(points: list[dict], title: str = "Rate-distortion"):
    """Matplotlib R-D plot (bpp against PSNR)."""
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 4))
    key = "bpp_actual" if "bpp_actual" in points[0] else "bpp_entropy"
    ax.plot([p[key] for p in points], [p["psnr_db"] for p in points], "o-")
    for p in points:
        ax.annotate(f"q={p['step']}", (p[key], p["psnr_db"]), fontsize=8)
    ax.set_xlabel("bits per pixel")
    ax.set_ylabel("PSNR (dB)")
    ax.set_title(title)
    ax.grid(alpha=0.3)
    return fig


# ---------------------------------------------------------------------------
# PCRD: fine encode -> measured per-plane R-D tables -> Lagrangian
# truncation through the WCT9 band_div divisor table
# ---------------------------------------------------------------------------

# dyadic anchors with 1.5x steps between them; 255 caps the ladder (the WCT9
# table stores one u8 per plane)
DIVISORS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128, 192, 255)


@functools.lru_cache(maxsize=16)
def synthesis_gains(wavelet: str, levels: int) -> tuple[tuple[float, float, float], ...]:
    """Per-(level, band) synthesis energy gains, fine to coarse: the image
    SSE of a unit coefficient in that band, measured by an impulse through
    the inverse transform on the CPU (exact for any registered filter;
    biorthogonal synthesis is not energy-preserving)."""
    size = 32 << levels  # room for the widest cascade support
    gains = []
    for lvl in range(1, levels + 1):
        per_band = []
        for band in range(3):
            amp = 1.0
            if wavelet == "haar":
                details = []
                for l2 in range(1, levels + 1):
                    sh = size >> l2
                    bands = [torch.zeros((sh, sh), dtype=torch.float32) for _ in range(3)]
                    if l2 == lvl:
                        bands[band][sh // 2, sh // 2] = 1.0
                    details.append(tuple(bands))
                pyr = Pyramid(ll=torch.zeros((size >> levels, size >> levels), dtype=torch.float32),
                              details=tuple(details), wavelet="haar", orig_shape=(size, size))
                img = idwt2(pyr).numpy()
            else:
                name = {"bior4.4": "cdf97"}.get(wavelet, wavelet)
                # integer lifting floors its update steps: a large integer
                # impulse, renormalized (relative error about 1/amp)
                integer = is_integer_wavelet(name)
                amp = 4096.0 if integer else 1.0
                dt = torch.int32 if integer else torch.float32
                sh = size >> lvl
                x = torch.zeros((sh, sh), dtype=dt)
                bands = [torch.zeros((sh, sh), dtype=dt) for _ in range(3)]
                bands[band][sh // 2, sh // 2] = amp
                x = idwt2_level_lifting(x, *bands, name)
                for l2 in range(lvl - 1, 0, -1):
                    sh = size >> l2
                    z = torch.zeros((sh, sh), dtype=dt)
                    x = idwt2_level_lifting(x, z, z, z, name)
                img = x.numpy()
            per_band.append(float((img.astype(np.float64) ** 2).sum() / (amp * amp)))
        gains.append(tuple(per_band))
    return tuple(gains)


def _dequant_np(c: np.ndarray, step: float, offset: float = 0.5) -> np.ndarray:
    cf = c.astype(np.float64)
    return np.sign(cf) * (np.abs(cf) + offset) * step


@dataclasses.dataclass(frozen=True)
class PlaneRD:
    """R-D candidates of one stored plane: parallel (divisor, bytes,
    image-domain distortion) triples, divisor-ascending."""

    divs: tuple[int, ...]
    rates: tuple[int, ...]
    dists: tuple[float, ...]


def measure(stream: CodeStream, divisors: tuple[int, ...] = DIVISORS, codec: str = "auto") -> list[PlaneRD]:
    """Per-plane R-D tables of ``stream`` (its planes copied to the host
    once). Rate: entropy-coded bytes by the container's coder; distortion:
    against the stream's own fine-step codes, weighted by the synthesis
    gains (and ICT chroma planes by ``chroma_gain**2``)."""
    if stream.roi_shift:
        raise ValueError("R-D truncation of ROI-coded streams is unsupported")
    if stream.band_div:
        raise ValueError("stream already carries R-D divisors")
    integer = is_integer_wavelet(stream.wavelet)
    gains = synthesis_gains(stream.wavelet, stream.levels)
    chan_w: np.ndarray | None = None
    if stream.color == "ict" and stream.chroma_gain != 1.0:
        g2 = float(stream.chroma_gain) ** 2
        chan_w = np.array([1.0, g2, g2], np.float64)
    planes = iter(host_arrays([b for bands in stream.details for b in bands]))
    out = []
    for lvl in range(1, stream.levels + 1):
        steps = (1.0, 1.0, 1.0) if integer else stream.spec.band_steps(lvl)
        for band in range(3):
            c = next(planes)
            q = steps[band]
            g = gains[lvl - 1][band]
            mag = np.abs(c.astype(np.int32))
            sg = np.sign(c.astype(np.int32))
            # integer streams: codes are coefficients (reconstruction offset 0)
            ref = mag.astype(np.float64) * sg if integer else _dequant_np(c, q)
            divs, rates, dists = [], [], []
            for d in divisors:
                if d == 1:
                    cd, rec = c, ref
                else:
                    m2 = mag // d
                    cd = (sg * m2).astype(c.dtype)
                    if integer:
                        rec = np.where(m2 > 0, (m2 * d + d // 2), 0).astype(np.float64) * sg
                    else:
                        rec = _dequant_np(cd, q * d)
                err = ref - rec
                if chan_w is not None and err.ndim >= 3 and err.shape[-3] >= 3:
                    w = np.ones(err.shape[-3], np.float64)
                    w[:3] = chan_w
                    sse = float(((err * err).sum(axis=(-2, -1)) * w).sum())
                else:
                    sse = float((err * err).sum())
                dists.append(g * sse)
                # the coder wants (h, w) or (planes, h, w): leading dims flatten
                rates.append(len(_encode_plane(cd.reshape((-1,) + cd.shape[-2:]), codec)[1]))
                divs.append(d)
                if not np.any(cd):
                    break  # coarser divisors give the same all-zero plane
            out.append(PlaneRD(tuple(divs), tuple(rates), tuple(dists)))
    return out


def _hull(t: PlaneRD) -> list[tuple[int, int, float]]:
    """Lower convex hull of one plane's (rate, dist) candidates: [(div,
    rate, dist)] rate-descending, slopes strictly increasing."""
    pts = sorted(zip(t.divs, t.rates, t.dists), key=lambda p: (-p[1], p[2]))
    mono: list[tuple[int, int, float]] = []
    for dv, r, d in pts:
        if mono and r >= mono[-1][1]:
            continue  # no rate reduction: dominated
        while mono and mono[-1][2] >= d:
            mono.pop()  # dominated: this point is cheaper and no worse
        mono.append((dv, r, d))
    hull: list[tuple[int, int, float]] = []
    for p in mono:
        while len(hull) >= 2:
            d1, r1, D1 = hull[-2]
            d2, r2, D2 = hull[-1]
            s_prev = (D2 - D1) / max(r1 - r2, 1e-12)
            s_new = (p[2] - D2) / max(r2 - p[1], 1e-12)
            if s_new <= s_prev:
                hull.pop()
            else:
                break
        hull.append(p)
    return hull


def allocate(tables: list[PlaneRD], budget_bytes: int) -> tuple[tuple[int, ...], int, float]:
    """Per-plane divisors meeting ``budget_bytes`` (entropy bytes of all
    detail planes) with least total distortion: a greedy sweep over the
    per-plane hulls in increasing distortion per byte saved, then a fill-back
    of the remaining budget. Returns (divisors, total_rate, total_dist)."""
    hulls = [_hull(t) for t in tables]
    choice = [0] * len(hulls)
    rate = sum(h[0][1] for h in hulls)
    dist = sum(h[0][2] for h in hulls)
    heap: list[tuple[float, int]] = []  # (slope, plane) candidate moves
    for i, h in enumerate(hulls):
        if len(h) > 1:
            heapq.heappush(heap, ((h[1][2] - h[0][2]) / max(h[0][1] - h[1][1], 1e-12), i))
    while rate > budget_bytes and heap:
        _, i = heapq.heappop(heap)
        h = hulls[i]
        j = choice[i]
        rate -= h[j][1] - h[j + 1][1]
        dist += h[j + 1][2] - h[j][2]
        choice[i] = j + 1
        if j + 2 < len(h):
            heapq.heappush(heap, ((h[j + 2][2] - h[j + 1][2]) / max(h[j + 1][1] - h[j + 2][1], 1e-12), i))
    # fill-back: undo the refinements with the best distortion reduction per
    # byte that still fit (one live entry per plane, so popped slopes match)
    refine: list[tuple[float, int]] = []
    for i, h in enumerate(hulls):
        j = choice[i]
        if j > 0:
            heapq.heappush(refine, (-(h[j][2] - h[j - 1][2]) / max(h[j - 1][1] - h[j][1], 1e-12), i))
    while refine:
        _, i = heapq.heappop(refine)
        h = hulls[i]
        j = choice[i]
        dr = h[j - 1][1] - h[j][1]
        if rate + dr > budget_bytes:
            continue  # does not fit; cheaper planes may still
        rate += dr
        dist -= h[j][2] - h[j - 1][2]
        choice[i] = j - 1
        if j - 1 > 0:
            heapq.heappush(refine, (-(h[j - 1][2] - h[j - 2][2]) / max(h[j - 2][1] - h[j - 1][1], 1e-12), i))
    return tuple(hulls[i][choice[i]][0] for i in range(len(hulls))), rate, dist


def truncate(stream: CodeStream, target_bpp: float | None = None, target_bytes: int | None = None,
             divisors: tuple[int, ...] = DIVISORS, codec: str = "auto", ll_codec: str = "raw",
             ll_step: float = 0.125) -> CodeStream:
    """R-D-optimally truncate a fine-step stream to a budget on the whole
    container (header, LL and planes): ``target_bpp`` or ``target_bytes``.
    The divisors land in ``band_div`` (the WCT9 table) and the codes are
    floor-divided where they lie; every decode path applies ``step * div``.
    Pass the ``ll_codec``/``ll_step`` that ``save`` will use, so the
    overhead estimate matches. One deliberate difference from the
    reference: the overhead counts the WCT9 header exactly, so the
    container meets the budget wherever the divisor ladder allows."""
    if (target_bpp is None) == (target_bytes is None):
        raise ValueError("pass exactly one of target_bpp / target_bytes")
    h, w = stream.orig_shape
    if target_bytes is None:
        target_bytes = int(target_bpp * h * w / 8.0)
    tables = measure(stream, divisors, codec)
    base_rate = sum(t.rates[0] for t in tables)
    # the overhead is a full serialize less the planes' entropy bytes, with
    # the WCT9 header the result will carry: serialize writes band_div into
    # the header only (never into the codes), so a placeholder table sizes it
    # exactly. (The reference adds levels*3 bytes to the header of the stream
    # as it is, which misses the extended block of a WCT4-6 stream, 10 bytes
    # for a WCT4 one, and can overshoot the budget by that much.)
    # Quality-layer sections added at save time are left out. Leading batch
    # dimensions flatten to one stack of planes for the estimate.
    est = dataclasses.replace(stream, band_div=(2,) * (3 * stream.levels))
    if stream.ll.ndim > 3:
        est = dataclasses.replace(
            est, ll=stream.ll.reshape((-1,) + tuple(stream.ll.shape[-2:])),
            details=tuple(tuple(p.reshape((-1,) + tuple(p.shape[-2:])) for p in bands) for bands in stream.details))
    overhead = len(serialize(est, codec=codec, ll_codec=ll_codec, ll_step=ll_step)) - base_rate
    divs, _, _ = allocate(tables, max(target_bytes - overhead, 0))
    details = []
    it = iter(divs)
    for bands in stream.details:
        row = []
        for plane in bands:
            d = next(it)
            if d > 1:
                ci = plane.to(torch.int32)
                plane = (torch.sign(ci) * (ci.abs() // d)).to(plane.dtype)
            row.append(plane)
        details.append(tuple(row))
    band_div = tuple(int(d) for d in divs)
    if all(d == 1 for d in band_div):
        band_div = ()
    return dataclasses.replace(stream, details=tuple(details), band_div=band_div)
