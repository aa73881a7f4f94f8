"""The CUDA kernels of ``wicca_tpu_torch/csrc`` (every source file) built by the host C++
compiler (``host_emulation.h`` runs each launch thread by thread, or block by
block with the threads as fibers that switch at every barrier) and held
against their plain PyTorch twins through the wrappers' own launch code.
This checks the kernels' indexing and arithmetic without a card; the card
itself runs the same comparison in ``chip_smoke.py``. Tolerance 0."""

import shutil

import numpy as np
import pytest
import torch

from wicca_tpu_torch.core.pad import pad_to_multiple
from wicca_tpu_torch.ops import _build
from wicca_tpu_torch.ops import dwt53_cuda, dwt97_cuda, pack_cuda
from wicca_tpu_torch.ops import dwt_cuda as ops

STEP_SETS = {
    "int8": lambda k: tuple((1.0,) * 3 for _ in range(k)),
    "int16": lambda k: tuple((0.75,) * 3 for _ in range(k)),
    "hh1.5": lambda k: tuple((0.75 * 1.5**i, 0.75 * 1.5**i, 0.75 * 1.5**i * 1.5) for i in range(k)),
    "mixed": lambda k: tuple((2.5, 2.5, 3.75) if i % 2 else (0.3, 0.3, 0.45) for i in range(k)),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tensors here are small: torch's intra-op threads cost far more
    than they save when the suite's workers share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def host_lib():
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler")
    return _build.host_library(cxx)


def _equal(got: torch.Tensor, want: torch.Tensor) -> None:
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want), float((got.double() - want.double()).abs().max())


@pytest.mark.parametrize("depth", [1, 2, 3, 4, 5, 6, 7, 8])
def test_icon_kernel_matches_plain(host_lib, depth):
    rng = np.random.default_rng(depth)
    x = pad_to_multiple(torch.from_numpy(rng.integers(0, 256, (2, 3, 61, 83), dtype=np.uint8)), 1 << depth,
                        mode="reflect101").contiguous()
    _equal(ops._launch_icon(host_lib, x, depth, 0), ops.icon_plain(x, depth))
    sat = torch.zeros((1, 256, 256), dtype=torch.uint8)
    sat[..., 128:] = 255
    _equal(ops._launch_icon(host_lib, sat, depth, 0), ops.icon_plain(sat, depth))


# Inputs of the K2/K3 cases. For K3 at k = 3, whose uint8 tiles are two
# level-3 columns wide: "u8" and "f32" leave the last tile of a row one
# column (masked, column by column accesses), the "-even" and "-wide" ones
# fill every tile (whole-tile accesses), "-wide" with more blocks of tiles
# than one. The uint8 inputs have a leading batch dimension.
SOURCES = {
    "u8": (2, 3, 37, 71),
    "f32": (3, 45, 50),
    "u8-even": (2, 3, 21, 80),
    "f32-even": (3, 14, 48),
    "u8-wide": (2, 3, 400, 256),
    "f32-wide": (2, 512, 320),
}


@pytest.mark.parametrize("steps_name", STEP_SETS)
@pytest.mark.parametrize("src", SOURCES)
@pytest.mark.parametrize("k", [1, 2, 3])
def test_dwt_and_idwt_kernels_match_plain(host_lib, k, src, steps_name):
    rng = np.random.default_rng(k)
    if src.startswith("u8"):
        x = torch.from_numpy(rng.integers(0, 256, SOURCES[src], dtype=np.uint8))
    else:
        x = torch.from_numpy((rng.random(SOURCES[src]) * 300 - 20).astype(np.float32))
    x = pad_to_multiple(x, 1 << k).contiguous()
    steps = STEP_SETS[steps_name](k)
    ll, dets = ops._launch_dwt(host_lib, x, steps, 0)
    pll, pdets = ops.dwt_multilevel_quant_plain(x, steps)
    _equal(ll, pll)
    for bands, pbands in zip(dets, pdets):
        for a, b in zip(bands, pbands):
            _equal(a, b)
    for emit_u8 in (False, True):
        for off in (0.5, 0.3):
            _equal(ops._launch_idwt(host_lib, ll, dets, steps, emit_u8, off, 0),
                   ops.idwt_multilevel_dequant_plain(ll, dets, steps, emit_u8, off))


def test_codec_pass_structure_matches_plain(host_lib):
    """Depths 3, 5 and 6 as the codec runs them: levels 1-3 from uint8, the
    levels after them from float32 (4-5 at depth 5, 4-6 at depth 6), then the
    inverse passes, the finest emitting uint8."""
    for depth in (3, 5, 6):
        x = torch.from_numpy(np.random.default_rng(depth).integers(0, 256, (3, 128, 192), dtype=np.uint8))
        steps = [(0.75 * 1.5**i,) * 2 + (1.125 * 1.5**i,) for i in range(depth)]
        passes = [tuple(steps[lo:lo + 3]) for lo in range(0, depth, 3)]
        ll, dets, pll, pdets = x, [], x, []
        for s in passes:
            ll, d = ops._launch_dwt(host_lib, ll, s, 0)
            pll, pd = ops.dwt_multilevel_quant_plain(pll, s)
            dets.append(d)
            pdets.append(pd)
        rec, prec = ll, pll
        for i in range(len(passes) - 1, -1, -1):
            rec = ops._launch_idwt(host_lib, rec, dets[i], passes[i], i == 0, 0.5, 0)
            prec = ops.idwt_multilevel_dequant_plain(prec, pdets[i], passes[i], emit_u8=i == 0)
        _equal(rec, prec)


@pytest.mark.parametrize("step,quantize", [(1.0, True), (0.75, True), (1.0, False)])
@pytest.mark.parametrize("shape", [(2, 3, 38, 70), (1, 1100, 96), (1, 72, 1100)])
def test_level_kernels_match_plain(host_lib, shape, step, quantize):
    """K4 and K5, with the tile padding (H > 512, W > 1024) read as clamps."""
    x = torch.from_numpy((np.random.default_rng(3).random(shape) * 300 - 20).astype(np.float32))
    bands = ops._launch_dwt_level(host_lib, x, step, quantize, 0)
    for a, b in zip(bands, ops.dwt_level_quant_plain(x, step, quantize)):
        _equal(a, b)
    _equal(ops._launch_idwt_level(host_lib, bands[0], bands[1:], step, quantize, 0),
           ops.idwt_level_dequant_plain(*bands, step, quantize))


@pytest.mark.parametrize("src", ["u8", "i32"])
@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("filt", ["legall5.3", "haar_int"])
def test_lifting_kernels_match_plain(host_lib, filt, k, src):
    """K6 and K7 on shapes that cross the tile seams in each direction, full
    and partial (orig_k > k) inverse passes, int32 and uint8 out."""
    rng = np.random.default_rng(k)
    for shape in [(2, 1104, 96), (1, 72, 1104), (2, 3, 40, 24)]:
        x = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8) if src == "u8"
                             else rng.integers(-300, 300, shape).astype(np.int32))
        _lifting_roundtrip(host_lib, x, k, filt)


def _lifting_roundtrip(host_lib, x, k, filt, color="none"):
    """K6 on x and K7 back (int32 and uint8 out, and the partial passes an
    encoder's k-level pass allows), each equal to its plain twin."""
    ll, dets = dwt53_cuda._launch_fwd(host_lib, x, k, filt, 0, color)
    pll, pdets = dwt53_cuda.dwt53_multilevel_plain(x, k, filt, color)
    _equal(ll, pll)
    for bands, pbands in zip(dets, pdets):
        for a, b in zip(bands, pbands):
            _equal(a, b)
    for emit_u8 in (False, True):
        _equal(dwt53_cuda._launch_inv(host_lib, ll, dets, k, emit_u8, k, filt, 0, color),
               dwt53_cuda.idwt53_multilevel_plain(ll, dets, k, emit_u8, k, filt, color))
        for kk in range(1, k):
            _equal(dwt53_cuda._launch_inv(host_lib, ll, dets[k - kk:], kk, emit_u8, k, filt, 0, color),
                   dwt53_cuda.idwt53_multilevel_plain(ll, dets[k - kk:], kk, emit_u8, k, filt, color))


@pytest.mark.parametrize("src", ["u8", "i32"])
@pytest.mark.parametrize("filt", ["legall5.3", "haar_int"])
def test_lifting_kernels_chunks_meet_inside_tiles(host_lib, filt, src):
    """K6 and K7 on a frame where several units' chunks of rows meet inside
    a tile and several warps' strips share a tile row, at every level, and
    tile seams cross both ways (600 rows pad to two 512-row tiles, 1100 and
    1104 columns to two 1024-column tiles): k = 2 on 1100 columns (uint8
    rows not 16-byte aligned: scalar loads) and k = 3 on 1104 (vector
    loads); uint8 and int32 in and out, partial passes."""
    rng = np.random.default_rng(40)
    for k, w in ((2, 1100), (3, 1104)):
        shape = (1, 600, w)
        x = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8) if src == "u8"
                             else rng.integers(-300, 300, shape).astype(np.int32))
        _lifting_roundtrip(host_lib, x, k, filt)


@pytest.mark.parametrize("channels", [3, 4])
def test_rct_folded_lifting_kernels_match_plain(host_lib, channels):
    """K6 with the RCT in its first level and K7 with the inverse RCT in its
    last, RGB and RGBA (alpha lifted as it is), from uint8 and int32, to
    int32 and uint8, both filters at k = 1-3 on a batched small shape, and
    across a tile seam (1100 columns: unaligned rows, read directly; 1104:
    aligned, through the rings); partial passes. The
    twins are the codec's composition (the RCT, then the plain levels; the
    plain levels, then the inverse RCT and the clip)."""
    rng = np.random.default_rng(50 + channels)
    cases = [(filt, k, (2, channels, 24, 40)) for filt in ("legall5.3", "haar_int") for k in (1, 2, 3)]
    seams = [("legall5.3", 2, (channels, 40, 1100)), ("legall5.3", 3, (channels, 80, 1104)),
             ("haar_int", 3, (channels, 80, 1104))]
    for filt, k, shape in cases + seams:
        for src in ("u8", "i32"):
            x = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8) if src == "u8"
                                 else rng.integers(-300, 300, shape).astype(np.int32))
            _lifting_roundtrip(host_lib, x, k, filt, "rct")


def test_lossless_pass_structure_matches_plain(host_lib):
    """Depth 5 as the lossless codec runs it: levels 1-3 from uint8 (rows
    padded to 1536 by the tiling), 4-5 from the int32 LL, then the inverse
    passes, the finest emitting uint8, and a partial pass as decode_at_level
    runs it."""
    x = torch.from_numpy(np.random.default_rng(5).integers(0, 256, (3, 1088, 96), dtype=np.uint8))
    ll3, d13 = dwt53_cuda._launch_fwd(host_lib, x, 3, "legall5.3", 0)
    assert ll3.shape == (3, 192, 12)
    ll5, d45 = dwt53_cuda._launch_fwd(host_lib, ll3, 2, "legall5.3", 0)
    rec3 = dwt53_cuda._launch_inv(host_lib, ll5, d45, 2, False, 2, "legall5.3", 0)
    _equal(rec3, ll3)
    out = dwt53_cuda._launch_inv(host_lib, rec3, d13, 3, True, 3, "legall5.3", 0)
    _equal(out[..., :1088, :], x)
    pll3, pd13 = dwt53_cuda.dwt53_multilevel_plain(x, 3)
    pll5, pd45 = dwt53_cuda.dwt53_multilevel_plain(pll3, 2)
    _equal(ll5, pll5)
    prec3 = dwt53_cuda.idwt53_multilevel_plain(pll5, pd45, 2)
    _equal(rec3, prec3)
    _equal(dwt53_cuda._launch_inv(host_lib, rec3, d13[2:], 1, False, 3, "legall5.3", 0),
           dwt53_cuda.idwt53_multilevel_plain(prec3, pd13[2:], 1, orig_k=3))


FLOAT_STEPS = {  # per k: one of the step sets the codec meets, by filter
    "cdf97": lambda k: tuple((0.75 * 1.5**i, 0.75 * 1.5**i, 1.125 * 1.5**i) for i in range(k)),
    "db2": lambda k: tuple((1.0, 1.0, 1.0) if i % 2 else (0.3, 0.3, 0.45) for i in range(k)),
}


@pytest.mark.parametrize("src", ["u8", "f32"])
@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("filt", ["cdf97", "db2"])
def test_float_lifting_kernels_match_plain(host_lib, filt, k, src):
    """K8 and K9 on shapes that cross the tile seams in each direction, a
    batched odd one, and tiles of one pair (every clamp collapses onto it);
    full and partial (orig_k > k) inverse passes, float32 and uint8 out, two
    reconstruction offsets."""
    rng = np.random.default_rng(10 + k)
    steps = dwt97_cuda._band_steps3(FLOAT_STEPS[filt](k))
    for shape in [(2, 1100, 96), (1, 72, 1100), (2, 3, 37, 23), (1, 2, 6)]:
        x = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8) if src == "u8"
                             else (rng.random(shape) * 300 - 20).astype(np.float32))
        x = pad_to_multiple(x, 1 << k).contiguous()
        ll, dets = dwt97_cuda._launch_fwd(host_lib, x, steps, filt, 0)
        pll, pdets = dwt97_cuda.dwt97_multilevel_quant_plain(x, steps, filt)
        _equal(ll, pll)
        for bands, pbands in zip(dets, pdets):
            for a, b in zip(bands, pbands):
                _equal(a, b)
        for emit_u8, off in ((False, 0.5), (True, 0.5), (False, 0.3)):
            _equal(dwt97_cuda._launch_inv(host_lib, ll, dets, steps, emit_u8, k, filt, off, 0),
                   dwt97_cuda.idwt97_multilevel_dequant_plain(ll, dets, steps, emit_u8, k, filt, off))
        for kk in range(1, k):
            _equal(dwt97_cuda._launch_inv(host_lib, ll, dets[k - kk:], steps[k - kk:], False, k, filt, 0.5, 0),
                   dwt97_cuda.idwt97_multilevel_dequant_plain(ll, dets[k - kk:], steps[k - kk:], False, k, filt))


def test_float_pass_structure_matches_plain(host_lib):
    """Depth 5 as the lossy codec runs it: levels 1-3 from uint8 (rows
    padded to 1536 by the tiling), 4-5 from the float32 LL, the inverse
    passes with the finest emitting uint8, and a partial pass as
    decode_at_level runs it."""
    x = torch.from_numpy(np.random.default_rng(6).integers(0, 256, (3, 1088, 96), dtype=np.uint8))
    s13 = dwt97_cuda._band_steps3(tuple((1.0 * 1.5**i,) * 3 for i in range(3)))
    s45 = dwt97_cuda._band_steps3(tuple((1.0 * 1.5**i,) * 3 for i in range(3, 5)))
    ll3, d13 = dwt97_cuda._launch_fwd(host_lib, x, s13, "cdf97", 0)
    assert ll3.shape == (3, 192, 12)
    ll5, d45 = dwt97_cuda._launch_fwd(host_lib, ll3, s45, "cdf97", 0)
    assert ll5.shape == (3, 48, 3) and d45[0][0].shape == (3, 96, 6)
    rec3 = dwt97_cuda._launch_inv(host_lib, ll5, d45, s45, False, 2, "cdf97", 0.5, 0)
    out = dwt97_cuda._launch_inv(host_lib, rec3, d13, s13, True, 3, "cdf97", 0.5, 0)
    pll3, pd13 = dwt97_cuda.dwt97_multilevel_quant_plain(x, s13)
    pll5, pd45 = dwt97_cuda.dwt97_multilevel_quant_plain(pll3, s45)
    _equal(ll5, pll5)
    prec3 = dwt97_cuda.idwt97_multilevel_dequant_plain(pll5, pd45, s45)
    _equal(rec3, prec3)
    _equal(out, dwt97_cuda.idwt97_multilevel_dequant_plain(prec3, pd13, s13, emit_u8=True))
    _equal(dwt97_cuda._launch_inv(host_lib, prec3, d13[2:], s13[2:], False, 3, "cdf97", 0.5, 0),
           dwt97_cuda.idwt97_multilevel_dequant_plain(prec3, pd13[2:], s13[2:], orig_k=3))
    assert float((out[..., :1088, :].double() - x.double()).abs().mean()) < 2.0


@pytest.mark.parametrize("filt", ["cdf97", "db2"])
def test_float_kernels_blocks_meet_inside_tiles(host_lib, filt):
    """K8 and K9 at k = 3 on a frame where several blocks' regions meet
    inside a tile in both directions at every level, and tile seams cross
    both ways (600 rows pad to two 512-row tiles, 1100 columns to two
    1024-column tiles); uint8 and float32 out, a partial pass."""
    rng = np.random.default_rng(20)
    x = pad_to_multiple(torch.from_numpy(rng.integers(0, 256, (1, 600, 1100), dtype=np.uint8)), 8).contiguous()
    steps = dwt97_cuda._band_steps3(FLOAT_STEPS[filt](3))
    ll, dets = dwt97_cuda._launch_fwd(host_lib, x, steps, filt, 0)
    pll, pdets = dwt97_cuda.dwt97_multilevel_quant_plain(x, steps, filt)
    _equal(ll, pll)
    for bands, pbands in zip(dets, pdets):
        for a, b in zip(bands, pbands):
            _equal(a, b)
    for emit_u8 in (False, True):
        _equal(dwt97_cuda._launch_inv(host_lib, ll, dets, steps, emit_u8, 3, filt, 0.5, 0),
               dwt97_cuda.idwt97_multilevel_dequant_plain(ll, dets, steps, emit_u8, 3, filt))
    _equal(dwt97_cuda._launch_inv(host_lib, ll, dets[2:], steps[2:], False, 3, filt, 0.5, 0),
           dwt97_cuda.idwt97_multilevel_dequant_plain(ll, dets[2:], steps[2:], False, 3, filt))


@pytest.mark.parametrize("gain", [1.0, 2.0])
@pytest.mark.parametrize("channels", [3, 4])
def test_ict_folded_float_kernels_match_plain(host_lib, channels, gain):
    """K8 with the ICT in its first level and K9 with the inverse ICT in its
    last, RGB and RGBA (alpha lifted as it is), chroma gain 1 and 2, from
    uint8 and float32, to float32 and uint8, both filters at k = 1-3 on a
    batched odd shape, and across a tile seam; a partial pass; the twins
    are the codec's composition (ICT, then the plain levels; the plain
    levels, then the inverse ICT and the clip)."""
    rng = np.random.default_rng(30 + channels)
    cases = [(filt, k, (2, channels, 24, 40)) for filt in ("cdf97", "db2") for k in (1, 2, 3)]
    for filt, k, shape in cases + [("cdf97", 2, (channels, 40, 1100))]:
        steps = dwt97_cuda._band_steps3(FLOAT_STEPS[filt](k))
        for src in ("u8", "f32"):
            x = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8) if src == "u8"
                                 else (rng.random(shape) * 300 - 20).astype(np.float32))
            x = pad_to_multiple(x, 1 << k).contiguous()
            ll, dets = dwt97_cuda._launch_fwd(host_lib, x, steps, filt, 0, "ict", gain)
            pll, pdets = dwt97_cuda.dwt97_multilevel_quant_plain(x, steps, filt, "ict", gain)
            _equal(ll, pll)
            for bands, pbands in zip(dets, pdets):
                for a, b in zip(bands, pbands):
                    _equal(a, b)
            for emit_u8 in (False, True):
                _equal(dwt97_cuda._launch_inv(host_lib, ll, dets, steps, emit_u8, k, filt, 0.5, 0, "ict", gain),
                       dwt97_cuda.idwt97_multilevel_dequant_plain(ll, dets, steps, emit_u8, k, filt, 0.5, "ict", gain))
            if k > 1:
                _equal(dwt97_cuda._launch_inv(host_lib, ll, dets[1:], steps[1:], True, k, filt, 0.3, 0, "ict", gain),
                       dwt97_cuda.idwt97_multilevel_dequant_plain(ll, dets[1:], steps[1:], True, k, filt, 0.3, "ict",
                                                                  gain))


# ---------------------------------------------------------------------------
# P1-P3: the PACK1 kernels (ops/pack_cuda.py)
# ---------------------------------------------------------------------------


def _escapes_plane(dtype, counts, n, seed):
    """A plane of zeros with ``counts[s]`` escapes (|c| >= 1, so z >= 1 =
    the k = 1 marker) at random places of segment s; past ``n`` nothing."""
    rng = np.random.default_rng(seed)
    x = np.zeros(n, dtype)
    for s, c in enumerate(counts):
        lo, hi = s * pack_cuda.SEG, min((s + 1) * pack_cuda.SEG, n)
        x[rng.choice(np.arange(lo, hi), c, replace=False)] = rng.integers(1, 100, c) * rng.choice([-1, 1], c)
    return torch.from_numpy(x)


def _laplace_plane(shape, dtype, scale, seed):
    info = np.iinfo(dtype)
    x = np.round(np.random.default_rng(seed).laplace(0, scale, shape))
    x = np.clip(x, info.min, info.max).astype(dtype)
    x.reshape(-1)[:3] = info.min  # zigzag's largest code
    return torch.from_numpy(x)


# name -> (planes, (k, cap) per plane)
PACK_CASES = {
    # k = 1: a segment with exactly C escapes, one with fewer (its row padded
    # with its first non-escapes), and a padded last segment
    "k1-escapes-up-to-C": (lambda: [_escapes_plane(np.int8, (16, 5, 3), 2 * 4096 + 700, 1),
                                    _escapes_plane(np.int16, (64, 63, 1), 2 * 4096 + 33, 2)],
                           [(1, 16), (1, 64)]),
    # k == width: raw zigzag codes (int8, int16), next to packed planes
    "k-width": (lambda: [_laplace_plane((3, 40, 50), np.int8, 30, 3), _laplace_plane((2, 37, 91), np.int16, 900, 4),
                         _laplace_plane((1, 4096), np.int8, 2, 5)],
                [(8, 0), (16, 0), (3, 512)]),
    "mixed": (lambda: [_laplace_plane((3, 40, 50), np.int8, 3, 6), _laplace_plane((1, 4096), np.int8, 1, 7),
                       _laplace_plane((2, 37, 91), np.int16, 40, 8), _laplace_plane((5000,), np.int16, 0.3, 9)],
              [(4, 256), (2, 512), (9, 64), (15, 16)]),
}


@pytest.mark.parametrize("case", PACK_CASES)
def test_pack_kernels_match_plain(host_lib, case):
    """P1 (statistics) and P2 (the packed buffer, LL appended) against their
    twins; tolerance 0."""
    make, kcs = PACK_CASES[case]
    planes = make()
    ll = torch.from_numpy(np.random.default_rng(0).random((3, 5, 7)).astype(np.float32))
    _equal(pack_cuda._launch_stats(host_lib, planes, 0), pack_cuda.pack1_stats_plain(planes))
    _equal(pack_cuda._launch_pack(host_lib, planes, kcs, ll, 0), pack_cuda.pack1_pack_plain(planes, kcs, ll))


def test_pack_kernel_splits_long_plane_lists(host_lib, monkeypatch):
    """More planes than one launch's table holds: one launch per part."""
    monkeypatch.setattr(pack_cuda, "MAX_PLANES", 2)
    planes = PACK_CASES["mixed"][0]()
    kcs = PACK_CASES["mixed"][1]
    ll = torch.arange(12, dtype=torch.int32)
    pack_cuda.reset_launches()
    _equal(pack_cuda._launch_stats(host_lib, planes, 0), pack_cuda.pack1_stats_plain(planes))
    _equal(pack_cuda._launch_pack(host_lib, planes, kcs, ll, 0), pack_cuda.pack1_pack_plain(planes, kcs, ll))
    assert pack_cuda.LAUNCHES == {"pack1_stats": 2, "pack1_pack": 3, "pack1_unpack": 0}


@pytest.mark.parametrize("case", PACK_CASES)
def test_unpack_kernel_matches_plain(host_lib, case):
    """P3 on the upload the host packs (fields, corrections padded to a
    bucket with repeats, raw planes) lands the planes, as its twin does."""
    from wicca_tpu_torch.codec import transfer

    planes = PACK_CASES[case][0]()
    meta = transfer._plane_meta([(tuple(p.shape), p.dtype) for p in planes])
    packed = [transfer._pack_plane_host(p.numpy(), m) for p, m in zip(planes, meta)]
    buf, layout = transfer._upload_buffer(meta, packed, pinned=False)
    got = pack_cuda._launch_unpack(host_lib, buf, layout, 0)
    for g, w, p in zip(got, pack_cuda.pack1_unpack_plain(buf, layout), planes, strict=True):
        _equal(g, w)
        _equal(g, p)


def test_unpack_kernel_drops_corrections_outside_the_plane(host_lib):
    """Hand-made corrections: before the plane, in the padding past n
    (applied, not stored), past the padded plane (dropped), repeated."""
    n, k, width = 4096 + 300, 2, 16
    z = np.random.default_rng(11).integers(0, 4, pack_cuda._npad(n)).astype(np.int32)
    fields = pack_cuda.pack_fields(torch.from_numpy(z), k)
    pos = np.array([-5, 0, 17, 4095, 4096, 4399, 4399, n + 10, 8191, 8192, 9000], np.int32)
    vals = np.array([7, 300, 65535, 9, 1000, 2, 2, 40000, 5, 6, 7], np.uint16)
    off_pos = -(-fields.numel() // 4) * 4
    buf = torch.zeros(off_pos + 4 * pos.size + 2 * vals.size, dtype=torch.uint8)
    buf[: fields.numel()] = fields
    buf[off_pos : off_pos + 4 * pos.size] = torch.from_numpy(pos.view(np.uint8))
    buf[off_pos + 4 * pos.size :] = torch.from_numpy(vals.view(np.uint8))
    layout = [pack_cuda.UnpackPlane((n,), width, k, 0, pos.size, off_pos, off_pos + 4 * pos.size)]
    got = pack_cuda._launch_unpack(host_lib, buf, layout, 0)[0]
    _equal(got, pack_cuda.pack1_unpack_plain(buf, layout)[0])
    want = z.copy()
    keep = (pos >= 0) & (pos < pack_cuda._npad(n))
    want[pos[keep]] = vals[keep]
    _equal(got, pack_cuda.unzigzag(torch.from_numpy(want[:n]), width))
