#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``wicca_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py [--seed 0] [--reps 20]

Phases, each fatal on failure:

1. the card (``nvidia-smi``), torch and CUDA versions, the nvcc build of
   the kernels from ``wicca_tpu_torch/csrc`` (one nvcc per source, run
   together) and the g++ builds of the host libraries from
   ``wicca_tpu_torch/native``: the container's entropy coders, the folder
   pipeline's host Haar/5-3 levels (``idwt.cpp``) and its PNG writer
   (``pngw.cpp``, linked with zlib), each with its build time;
2. every kernel against its plain PyTorch twin on the same CUDA tensors
   (``torch.equal``: tolerance 0) over small shapes: for K1-K3 odd sizes,
   batched input, icon depths 1-8, k = 1-3 fused levels, uint8 and float32
   input, int8 and int16 codes, non-power-of-two steps, recon offsets and
   uint8 emission; for K4/K5 shapes past the (512, 1024) tile caps, int8,
   int16 and float details; for K6/K7 shapes that cross tile seams in each
   direction and a 600 x 1100 frame where units' chunks of rows meet inside
   tiles, both filters, k = 1-3, uint8 and int32 input, int32 and uint8
   output, partial passes (orig_k > k); for K8/K9 the same seams, a batched
   odd shape, a tile of one pair and the 600 x 1100 frame, where blocks meet
   inside tiles both ways, both filters (cdf97, db2), k = 1-3, uint8 and
   float32 input, steps 1.0, 0.75 and per band (hh x 1.5), offsets 0.5 and
   0.3, float32 and uint8 output, partial passes; K8/K9 with the ICT
   folded into their first and last launch (RGB and RGBA, chroma gain 1
   and 2) and K6/K7 with the RCT folded in the same way (RGB and RGBA, both
   filters, uint8 and int32 in, int32 and uint8 out, partial passes),
   against the codec's composition;
3. the paths at full size on a 3x8704x6144 uint8 frame (bench.py's shape),
   each driven with the launch counters set to 0 just before and read just
   after:
   a. the Haar main path: ``HaarCoder.get_small_copy`` (depth 5) and
      ``encode(levels=5, QuantSpec(1.0))`` -> ``decode(emit_u8=True)``, held
      equal to the plain path on the same tensors, PSNR > 30 dB;
   b. the lossless path: ``encode(levels=5, wavelet=legall5.3, color=rct)``
      -> ``decode(emit_u8=True)`` equal to the frame bit for bit, the LL and
      all 15 planes (tile-padded shapes) and ``decode_at_level(st, 2)``
      equal to the plain path; the same with ``color='none'`` and with
      ``haar_int``; then (after the counters are read) a ``decode_region``
      window across tile seams equal to the frame's crop. ``rct`` runs
      through the fold: K6's first launch reads the uint8 frame and applies
      the RCT, K7's last launch applies the inverse RCT and emits uint8;
   c. the single-level ops: ``ops.dwt_level_quant`` -> ``idwt_level_dequant``
      on the frame as float32 at step 1.0, equal to the plain twins;
   d. the lossy float-lifting path: ``encode(levels=5, QuantSpec(1.0),
      wavelet='bior4.4', color='ict', chroma_gain=2.0)`` (the headline),
      then ``decode(emit_u8=True)`` and ``decode_at_level(st, 2)``, the LL,
      all 15 code planes (tile-padded shapes checked) and both decodes equal
      to the plain path, PSNR > 30 dB; the same with ``bior4.4`` and ``db2``
      at ``color='none'``; then (after the counters are read) a
      ``decode_region`` window across tile seams equal to the crop of the
      decode. ``ict`` runs through the fold: K8's first launch reads the
      uint8 frame and applies the ICT, K9's last launch applies the inverse
      ICT and emits uint8;
   then, after phase 3's counters are read (their launches count nowhere;
   i and j run after phase 4's timings, whose profiler records they would
   thin):
   e. the ``.wct`` container: Haar ``QuantSpec(1.0)``, ``legall5.3`` +
      ``rct`` and ``bior4.4`` + ``ict`` (``chroma_gain=2``) encoded on the
      card, ``serialize`` (``codec='auto'``, checksums) and ``deserialize``
      onto the card equal the stream plane by plane and decode as it does
      bit for bit; a 2-layer prefix of a 3-layer file holds the prefix
      codes; ``ll_codec='rice'`` on the lossless stream roundtrips;
      ``inspect(verify=True)`` finds no corrupt unit; host times and source
      MB/s of serialize and deserialize;
   f. ROI: ``apply_roi`` (a rectangle across tile seams, ``bg_shift=2``) on
      the Haar and ``legall5.3`` + ``rct`` streams, a WCT6 file saved and
      loaded decodes as the stream in memory, the region as without ROI,
      the same icon, ``decode_at_level(st, 2)``; the time of ``apply_roi``;
   g. a seeded 1x46341x46341 uint8 plane (past 2**31 samples) through the
      lossless codec bit for bit, and the codes of a crop past sample 2**31
      equal to the plain twin's (K6/K7's 64-bit row offsets);
   h. rate control on a 3x2048x2048 crop: ``encode_to_bpp(crop, 1.0)`` and
      PCRD ``truncate`` to 1.0 bpp within budget, both decoding;
   i. the folder pipeline (``encode_folder``/``decode_folder``) on a seeded
      folder of photograph-like frames written as PNG: four 3x8704x6144, one
      3x4000x6000 (padded) and one 1x2048x2731 grayscale frame (read as RGB,
      as the reference's loader reads it), about 730 MB of uint8 source, and
      a ``notes.txt`` the listing leaves out; each folder call under the
      profiler with its own launch counters set to 0 just before and read
      just after (exact counts: the device routes K2/K3 twice per Haar
      frame, K6/K7 and K8/K9 once per level; the host routes none): Haar
      ``QuantSpec(1.0)`` depth 5 encoded on the device and the host route
      gives the same ``.wct`` bytes, equal to ``serialize(encode(frame))``;
      its decode on both routes, in full and at ``at_level=2``, the same PNG
      bytes, with pixels equal to ``decode(emit_u8=True)`` and
      ``decode_at_level(st, 2)``; ``legall5.3`` + ``rct`` decodes on both
      routes to the sources bit for bit; ``bior4.4`` + ``ict``
      (``chroma_gain=2``) goes to the device route on ``auto`` (and on
      ``path='host'``, which no tiled float wavelet takes) and equals the
      in-memory decode; ``resume=True`` on the finished folder encodes
      nothing. Printed: each run's metrics (``mp_per_s``, ``seconds``,
      ``bytes_out``, route counts), launches and device idle share (kernel
      time over wall time); one 3x8704x6144 frame through each stage of
      both routes timed step by step; the pinned link's H2D and D2H GB/s;
   j. the classification harness (``ClassifierProcessor``, the icon route
      forced to the device) on phase i's folder, ``transform_depth=(3, 5)``,
      each run under the profiler with its own launch counters: the zoo
      (SimpleCNN, MobileNetV2, ResNet50, EfficientNetB0, VGG16, DenseNet121,
      ViTS16 at 224x224, bfloat16) loaded on the card; a deterministic numpy
      classifier's CSVs on the card equal a ``device='cpu'`` run's byte for
      byte, K1 launched once per bucket group and stack chunk, the K1 icons
      equal ``icon_host``'s; the zoo run writes every classifier's CSVs at
      every depth (none disabled); per model, the card's float32 logits (TF32
      off for the comparison) within 1e-4 of the largest |logit| of the same
      module on the CPU and the bfloat16 top-1 where the float32 margin is
      clear, on a 12-image batch, with the forward's time at the harness's
      batch, images/s and TFLOP/s (operations counted from the layer shapes);
      ``compare='reconstruction'`` with MobileNetV2 for Haar (K2/K3),
      ``legall5.3`` + ``rct`` (K6/K7, every best class agreeing) and
      ``bior4.4`` + ``ict`` (K8/K9). Printed:
      each run's MP/s and stage seconds per depth, launches, device idle
      share;
4. times at the main-path shapes: each kernel pass's device time
   (``torch.profiler``, median of ``--reps`` launches after warm-up) and its
   wrapper call, its plain twin and the yardstick library call where there
   is one (CUDA events, median of ``--reps`` calls), the bytes each pass
   must move and its bound; the Haar and lossless depth-5 roundtrips called
   alone and back to back, with device-busy time and idle share; then the
   ``kernels`` JSON line (all nine kernels), whose times and bounds sum each
   kernel's passes as often as phase 3 ran them (fatal unless their
   launches add up to phase 3's count). The ``ict`` and ``none`` float
   roundtrips are timed alone and back to back.

The last line of output is ``{"ok": true, "device": {...}}``. Without a CUDA
device the script exits non-zero before printing any result.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

H, W, LEVELS = 8704, 6144, 5
HAAR_SOURCE = "wicca_tpu_torch/csrc/haar_kernels.cu"
LIFTING_SOURCE = "wicca_tpu_torch/csrc/lifting_kernels.cu"
FLOAT_SOURCE = "wicca_tpu_torch/csrc/lifting_float_kernels.cu"
# kernel -> (TPU kernel it replaces, CUDA source, substring of its device symbol)
KERNELS = {
    "icon": ("wicca_tpu/ops/dwt_pallas.py:171", HAAR_SOURCE, "icon_"),
    "dwt_multilevel_quant": ("wicca_tpu/ops/dwt_pallas.py:405", HAAR_SOURCE, "dwt_quant_kernel"),
    "idwt_multilevel_dequant": ("wicca_tpu/ops/dwt_pallas.py:498", HAAR_SOURCE, "idwt_dequant_kernel"),
    "dwt_level_quant": ("wicca_tpu/ops/dwt_pallas.py:230", HAAR_SOURCE, "haar_level_fwd_kernel"),
    "idwt_level_dequant": ("wicca_tpu/ops/dwt_pallas.py:291", HAAR_SOURCE, "haar_level_inv_kernel"),
    "dwt53_multilevel": ("wicca_tpu/ops/dwt53_pallas.py:140", LIFTING_SOURCE, "lift_fwd_lines_kernel"),
    "idwt53_multilevel": ("wicca_tpu/ops/dwt53_pallas.py:210", LIFTING_SOURCE, "lift_inv_lines_kernel"),
    "dwt97_multilevel_quant": ("wicca_tpu/ops/dwt97_pallas.py:155", FLOAT_SOURCE, "lift97_fwd_level_kernel"),
    "idwt97_multilevel_dequant": ("wicca_tpu/ops/dwt97_pallas.py:220", FLOAT_SOURCE, "lift97_inv_level_kernel"),
}
# H100 SXM rate outside the tensor cores, operations/s (float32; the integer
# lifting is counted against it too: every pass here is bound by bytes by
# two orders of magnitude either way)
F32_PEAK = 67e12


def hbm_bytes_per_s(name: str) -> float:
    """Published device-memory rate of the card ``nvidia-smi`` names."""
    if "H200" in name:
        return 4.8e12
    if "H100" in name and "PCIe" in name:
        return 2.0e12
    if "H100" in name and "NVL" in name:
        return 3.9e12
    return 3.35e12  # H100 SXM (HBM3)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def flat(details):
    return [b for bands in details for b in bands]


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median CUDA-event time of ``fn()`` over ``reps`` runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def loop_ms(fn, reps: int) -> float:
    """CUDA-event time per call of ``reps`` back-to-back calls of ``fn()``:
    the host enqueues the next call while the card runs this one."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int, match: str | None = None, per_call: int | None = None) -> float | None:
    """Median device time (ms) per call of ``fn()`` of the CUDA kernels whose
    name contains ``match`` (all kernels when None), from ``torch.profiler``.
    With ``per_call`` (the launches one call makes) the median runs over the
    complete calls recorded, since the profiler now and then records fewer
    launches than ran; None when it records no complete call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = [e.device_time for e in prof.events()
          if e.device_type == DeviceType.CUDA and (match is None or match in e.name)]
    if per_call:
        calls = len(us) // per_call
        if calls < reps:
            print(f"  note: the profiler recorded {len(us)} of {reps * per_call} launches of {match}")
        if not calls:
            return None
        return statistics.median(sum(us[i * per_call : (i + 1) * per_call]) for i in range(calls)) / 1e3
    if len(us) < reps:
        return None
    if len(us) % reps:  # calls that differ in their kernels: the mean per call
        return sum(us) / reps / 1e3
    per_call = len(us) // reps
    return statistics.median(sum(us[i * per_call : (i + 1) * per_call]) for i in range(reps)) / 1e3


def reset_all_launches() -> None:
    from wicca_tpu_torch.ops import dwt53_cuda, dwt97_cuda, dwt_cuda

    dwt_cuda.reset_launches()
    dwt53_cuda.reset_launches()
    dwt97_cuda.reset_launches()


def launch_counts() -> dict:
    from wicca_tpu_torch.ops import dwt53_cuda, dwt97_cuda, dwt_cuda

    return {**dwt_cuda.LAUNCHES, **dwt53_cuda.LAUNCHES, **dwt97_cuda.LAUNCHES}


def read_launches(names, path: str) -> dict:
    """The launch counts of ``names`` since the last reset; fails if one of
    them never launched."""
    counts = launch_counts()
    launches = {name: counts[name] for name in names}
    if not all(launches.values()):
        raise AssertionError(f"a kernel of {path} never launched: {launches}")
    return launches


def check_equal(what: str, got, want) -> None:
    if got.dtype != want.dtype or got.shape != want.shape or not torch.equal(got, want):
        diff = (got.double() - want.double()).abs().max().item() if got.shape == want.shape else None
        raise AssertionError(f"{what}: kernel {got.dtype}{tuple(got.shape)} != plain "
                             f"{want.dtype}{tuple(want.shape)}, max |diff| {diff}")


def check_pairs(pairs: dict) -> dict:
    """Hold every ``(what, kernel result, plain result)`` of each kernel in
    ``pairs`` equal; returns each kernel's largest |difference|, measured."""
    max_abs_err = {}
    for name, checks in pairs.items():
        for what, got, want in checks:
            check_equal(what, got, want)
        max_abs_err[name] = max((got.double() - want.double()).abs().max().item() for _, got, want in checks)
    return max_abs_err


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain twin at small shapes
# ---------------------------------------------------------------------------


def phase_kernels_vs_plain(rng, dev) -> int:
    from wicca_tpu_torch.core.pad import pad_to_multiple
    from wicca_tpu_torch.ops import dwt_cuda as ops

    n = 0
    odd = torch.from_numpy(rng.integers(0, 256, (2, 3, 61, 83), dtype=np.uint8)).to(dev)
    sat = torch.zeros((1, 256, 256), dtype=torch.uint8, device=dev)
    sat[:, :, 128:] = 255
    for depth in range(1, 9):
        for mode in ("replicate", "reflect101"):
            x = pad_to_multiple(odd, 1 << depth, mode=mode).contiguous()
            check_equal(f"icon depth {depth} {mode}", ops.icon(x, depth), ops.icon_plain(x, depth))
            n += 1
        check_equal(f"icon depth {depth} saturated", ops.icon(sat, depth), ops.icon_plain(sat, depth))
        n += 1

    step_sets = {
        "int8": lambda k: tuple(1.0 for _ in range(k)),
        "int16": lambda k: tuple(0.75 for _ in range(k)),
        "hh1.5": lambda k: tuple((0.75 * 1.5**i, 0.75 * 1.5**i, 0.75 * 1.5**i * 1.5) for i in range(k)),
        "mixed": lambda k: tuple((2.5, 2.5, 3.75) if i % 2 else (0.3, 0.3, 0.45) for i in range(k)),
    }
    u8 = torch.from_numpy(rng.integers(0, 256, (2, 3, 37, 71), dtype=np.uint8)).to(dev)
    f32 = torch.from_numpy((rng.random((3, 45, 50)) * 300 - 20).astype(np.float32)).to(dev)
    for k in (1, 2, 3):
        for src_name, src in (("u8", u8), ("f32", f32)):
            x = pad_to_multiple(src, 1 << k).contiguous()
            for steps_name, make in step_sets.items():
                steps = make(k)
                what = f"k={k} {src_name} {steps_name}"
                ll, dets = ops.dwt_multilevel_quant(x, steps)
                pll, pdets = ops.dwt_multilevel_quant_plain(x, steps)
                check_equal(f"dwt {what} ll", ll, pll)
                for i, (a, b) in enumerate(zip(flat(dets), flat(pdets))):
                    check_equal(f"dwt {what} band {i}", a, b)
                n += 1
                for emit_u8 in (False, True):
                    for off in (0.5, 0.3):
                        got = ops.idwt_multilevel_dequant(ll, dets, steps, emit_u8, off)
                        want = ops.idwt_multilevel_dequant_plain(ll, dets, steps, emit_u8, off)
                        check_equal(f"idwt {what} emit_u8={emit_u8} offset={off}", got, want)
                        n += 1

    # K4/K5: one tile, rows past 512 (padded to 1536), columns past 1024
    # (padded to 2048); int8, int16 and float details; uint8 and float input
    for shape in ((2, 3, 38, 70), (2, 1100, 96), (1, 72, 1100)):
        f = torch.from_numpy((rng.random(shape) * 300 - 20).astype(np.float32)).to(dev)
        for src_name, src in (("f32", f), ("u8", torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(dev))):
            for step, quantize in ((1.0, True), (0.75, True), (1.0, False)):
                what = f"level {src_name}{shape} step={step} quantize={quantize}"
                bands = ops.dwt_level_quant(src, step, quantize)
                for i, (a, b) in enumerate(zip(bands, ops.dwt_level_quant_plain(src, step, quantize))):
                    check_equal(f"{what} band {i}", a, b)
                check_equal(f"{what} inverse", ops.idwt_level_dequant(*bands, step, quantize),
                            ops.idwt_level_dequant_plain(*bands, step, quantize))
                n += 1
    return n + lifting_vs_plain(rng, dev) + ict_fold_vs_plain(rng, dev) + rct_fold_vs_plain(rng, dev)


FLOAT_STEP_SETS = {
    "1.0": lambda k: tuple(1.0 for _ in range(k)),
    "0.75": lambda k: tuple(0.75 for _ in range(k)),
    "hh1.5": lambda k: tuple((0.75 * 1.5**i, 0.75 * 1.5**i, 0.75 * 1.5**i * 1.5) for i in range(k)),
}


def lifting_vs_plain(rng, dev) -> int:
    """K6/K7 and K8/K9 against their twins: shapes that cross tile seams in
    each direction (1100 pads to a multiple of 2**k, then to the tile
    multiple), a batched odd shape, a 600 x 1100 frame where K6/K7's chunks
    of rows and K8/K9's blocks' regions meet inside tiles both ways (and for
    K8/K9 a tile of one pair), both
    filters of each, k = 1-3, uint8 input and int32 (K6) or float32 (K8)
    input, partial passes with orig_k > k. K7 emits int32 and uint8; K8/K9
    run three step sets and K9 emits float32 and uint8 at two offsets."""
    from wicca_tpu_torch.core.pad import pad_to_multiple
    from wicca_tpu_torch.ops import dwt53_cuda as lops
    from wicca_tpu_torch.ops import dwt97_cuda as fops

    # K6/K7 take a level count where K8/K9 take steps: their "steps" are k
    # Nones, so that a partial pass slices both alike
    families = {
        "lifting": dict(
            fwd=(lops.dwt53_multilevel, lops.dwt53_multilevel_plain),
            call_fwd=lambda f, x, s, filt: f(x, len(s), filt),
            inv=(lops.idwt53_multilevel, lops.idwt53_multilevel_plain),
            call_inv=lambda f, ll, dets, s, emit_u8, off, orig_k, filt: f(ll, dets, len(s), emit_u8, orig_k=orig_k,
                                                                         filt=filt),
            filters=("legall5.3", "haar_int"), step_sets={"levels": lambda k: (None,) * k},
            second=("i32", lambda shape: rng.integers(-300, 300, shape).astype(np.int32)),
            inverses=((False, None), (True, None)),
            shapes=((2, 1100, 96), (1, 72, 1100), (2, 3, 37, 23), (1, 600, 1100))),
        "float": dict(
            fwd=(fops.dwt97_multilevel_quant, fops.dwt97_multilevel_quant_plain),
            call_fwd=lambda f, x, s, filt: f(x, s, filt),
            inv=(fops.idwt97_multilevel_dequant, fops.idwt97_multilevel_dequant_plain),
            call_inv=lambda f, ll, dets, s, emit_u8, off, orig_k, filt: f(ll, dets, s, emit_u8, orig_k=orig_k,
                                                                         filt=filt, recon_offset=off),
            filters=("cdf97", "db2"), step_sets=FLOAT_STEP_SETS,
            second=("f32", lambda shape: (rng.random(shape) * 300 - 20).astype(np.float32)),
            inverses=((False, 0.5), (True, 0.5), (False, 0.3)),
            shapes=((2, 1100, 96), (1, 72, 1100), (2, 3, 37, 23), (1, 2, 6), (1, 600, 1100))),
    }
    n = 0
    for family, f in families.items():
        (fwd, fwd_plain), (inv, inv_plain), call_fwd, call_inv = f["fwd"], f["inv"], f["call_fwd"], f["call_inv"]
        second_name, make_second = f["second"]
        for shape in f["shapes"]:
            u8 = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(dev)
            second = torch.from_numpy(make_second(shape)).to(dev)
            for k in (1, 2, 3):
                for src_name, src in (("u8", u8), (second_name, second)):
                    x = pad_to_multiple(src, 1 << k).contiguous()
                    for filt in f["filters"]:
                        for steps_name, make in f["step_sets"].items():
                            s = make(k)
                            what = f"{family} {filt} k={k} {src_name}{tuple(x.shape)} {steps_name}"
                            ll, dets = call_fwd(fwd, x, s, filt)
                            pll, pdets = call_fwd(fwd_plain, x, s, filt)
                            check_equal(f"{what} ll", ll, pll)
                            for i, (a, b) in enumerate(zip(flat(dets), flat(pdets))):
                                check_equal(f"{what} band {i}", a, b)
                            for emit_u8, off in f["inverses"]:
                                check_equal(f"{what} inverse emit_u8={emit_u8} offset={off}",
                                            call_inv(inv, ll, dets, s, emit_u8, off, None, filt),
                                            call_inv(inv_plain, ll, dets, s, emit_u8, off, None, filt))
                                n += 1
                            for kk in range(1, k):
                                args = (dets[k - kk:], s[k - kk:], False, 0.5, k, filt)
                                check_equal(f"{what} partial {kk} of {k}", call_inv(inv, ll, *args),
                                            call_inv(inv_plain, ll, *args))
                                n += 1
    return n


def ict_fold_vs_plain(rng, dev) -> int:
    """K8 with the ICT in its first launch and K9 with the inverse ICT in
    its last, against the twins (the codec's composition): RGB and RGBA,
    chroma gain 1 and 2, uint8 and float32 input, float32 and uint8 output,
    both filters, k = 1-3 with a partial pass, on a frame where blocks meet
    inside tiles and across seams and on a batched odd shape."""
    from wicca_tpu_torch.core.pad import pad_to_multiple
    from wicca_tpu_torch.ops import dwt97_cuda as fops

    n = 0
    for channels in (3, 4):
        for shape in ((channels, 600, 1100), (2, channels, 37, 23)):
            srcs = (("u8", torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(dev)),
                    ("f32", torch.from_numpy((rng.random(shape) * 300 - 20).astype(np.float32)).to(dev)))
            for k in (1, 2, 3):
                s = FLOAT_STEP_SETS["hh1.5"](k)
                for src_name, src in srcs:
                    x = pad_to_multiple(src, 1 << k).contiguous()
                    for filt in ("cdf97", "db2"):
                        for gain in (1.0, 2.0):
                            what = f"ict fold {filt} k={k} {src_name}{tuple(x.shape)} gain={gain}"
                            ll, dets = fops.dwt97_multilevel_quant(x, s, filt, "ict", gain)
                            pll, pdets = fops.dwt97_multilevel_quant_plain(x, s, filt, "ict", gain)
                            check_equal(f"{what} ll", ll, pll)
                            for i, (a, b) in enumerate(zip(flat(dets), flat(pdets))):
                                check_equal(f"{what} band {i}", a, b)
                            for emit_u8 in (False, True):
                                args = (ll, dets, s, emit_u8, k, filt, 0.5, "ict", gain)
                                check_equal(f"{what} inverse emit_u8={emit_u8}", fops.idwt97_multilevel_dequant(*args),
                                            fops.idwt97_multilevel_dequant_plain(*args))
                                n += 1
                            if k > 1:
                                args = (ll, dets[1:], s[1:], True, k, filt, 0.3, "ict", gain)
                                check_equal(f"{what} partial", fops.idwt97_multilevel_dequant(*args),
                                            fops.idwt97_multilevel_dequant_plain(*args))
                                n += 1
    return n


def rct_fold_vs_plain(rng, dev) -> int:
    """K6 with the RCT in its first launch and K7 with the inverse RCT in
    its last against the codec's composition (the RCT, then the plain
    levels; the plain levels, then the inverse RCT and the clip): RGB and
    RGBA, a frame across tile seams where chunks meet inside tiles and a
    batched odd shape, both filters, k = 1-3, uint8 and int32 input, int32
    and uint8 output, a partial pass (orig_k > k)."""
    from wicca_tpu_torch.core.pad import pad_to_multiple
    from wicca_tpu_torch.ops import dwt53_cuda as lops

    n = 0
    for channels in (3, 4):
        for shape in ((channels, 600, 1100), (2, channels, 37, 23)):
            srcs = (("u8", torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(dev)),
                    ("i32", torch.from_numpy(rng.integers(-300, 300, shape).astype(np.int32)).to(dev)))
            for k in (1, 2, 3):
                for src_name, src in srcs:
                    x = pad_to_multiple(src, 1 << k).contiguous()
                    for filt in ("legall5.3", "haar_int"):
                        what = f"rct fold {filt} k={k} {src_name}{tuple(x.shape)}"
                        ll, dets = lops.dwt53_multilevel(x, k, filt, "rct")
                        pll, pdets = lops.dwt53_multilevel_plain(x, k, filt, "rct")
                        check_equal(f"{what} ll", ll, pll)
                        for i, (a, b) in enumerate(zip(flat(dets), flat(pdets))):
                            check_equal(f"{what} band {i}", a, b)
                        for emit_u8 in (False, True):
                            args = (ll, dets, k, emit_u8, k, filt, "rct")
                            check_equal(f"{what} inverse emit_u8={emit_u8}", lops.idwt53_multilevel(*args),
                                        lops.idwt53_multilevel_plain(*args))
                            n += 1
                        if k > 1:
                            args = (ll, dets[1:], k - 1, True, k, filt, "rct")
                            check_equal(f"{what} partial", lops.idwt53_multilevel(*args),
                                        lops.idwt53_multilevel_plain(*args))
                            n += 1
    return n


# ---------------------------------------------------------------------------
# phase 3: the main path at full size
# ---------------------------------------------------------------------------


def plain_roundtrip(x, levels, spec):
    """The codec's pass structure on the plain twins: the reference the
    main path is held to (x is already a multiple of 2**levels)."""
    from wicca_tpu_torch.codec.pipeline import _pass_sizes
    from wicca_tpu_torch.ops import dwt_cuda as ops

    ll, details, lvl = x, [], 0
    for k in _pass_sizes(levels):
        ll, dets = ops.dwt_multilevel_quant_plain(ll, tuple(spec.band_steps(lvl + i + 1) for i in range(k)))
        details.extend(dets)
        lvl += k
    rec, hi = ll, levels
    for k in reversed(_pass_sizes(levels)):
        lo = hi - k
        steps = tuple(spec.band_steps(i + 1) for i in range(lo, hi))
        rec = ops.idwt_multilevel_dequant_plain(rec, details[lo:hi], steps, emit_u8=lo == 0)
        hi = lo
    return ll, details, rec


def phase_main_path(frame_np, dev):
    from wicca_tpu_torch import HaarCoder, QuantSpec, decode, encode, psnr
    from wicca_tpu_torch.ops import dwt_cuda as ops

    spec = QuantSpec(base_step=1.0)
    x = torch.from_numpy(frame_np).to(dev)

    reset_all_launches()
    hwc_np = np.moveaxis(frame_np, 0, -1)
    icon_hwc = HaarCoder().get_small_copy(hwc_np, LEVELS, device=dev)  # numpy in, numpy out
    stream = encode(x, levels=LEVELS, spec=spec)
    rec = decode(stream, emit_u8=True)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    launches = read_launches(("icon", "dwt_multilevel_quant", "idwt_multilevel_dequant"), "the Haar main path")

    icon = torch.from_numpy(np.ascontiguousarray(np.moveaxis(icon_hwc, -1, 0))).to(dev)
    pll, pdets, prec = plain_roundtrip(x, LEVELS, spec)
    pairs = {
        "icon": [("main icon", icon, ops.icon_plain(x, LEVELS))],
        "dwt_multilevel_quant": [("main ll", stream.ll, pll)] + [
            (f"main band {i}", a, b) for i, (a, b) in enumerate(zip(flat(stream.details), flat(pdets)))
        ],
        "idwt_multilevel_dequant": [("main reconstruction", rec, prec)],
    }
    max_abs_err = check_pairs(pairs)
    db = float(psnr(rec, x))
    if not db > 30.0:
        raise AssertionError(f"roundtrip PSNR {db} dB <= 30")
    return x, launches, max_abs_err, db


LOSSLESS = (("legall5.3", "rct"), ("legall5.3", "none"), ("haar_int", "none"))  # the first is the headline


def plain_cascade(x, fwd, inv, color=(None, None), pair_local=False):
    """A codec's pass structure on the plain twins: the stream's LL and
    planes, the uint8 reconstruction and the level-2 decode. ``fwd(ll, lvl,
    k)`` runs a forward pass of k levels after level lvl; ``inv(rec, details,
    lo, hi, orig_k, emit_u8)`` the inverse pass of levels hi..lo+1 cut from a
    pass of orig_k levels; ``color`` is the pair of color transforms (None:
    none, and the finest pass emits uint8 itself); ``pair_local`` (haar_int)
    starts each pass from the semantic extent and crops the stream to it."""
    from wicca_tpu_torch.codec.pipeline import _crop_semantic, _pass_sizes

    to_color, from_color = color
    h, w = x.shape[-2], x.shape[-1]
    ll, details, lvl = (x if to_color is None else to_color(x)), [], 0
    for k in _pass_sizes(LEVELS):
        if pair_local:
            ll = ll[..., : h >> lvl, : w >> lvl]
        ll, dets = fwd(ll, lvl, k)
        details.extend(dets)
        lvl += k
    if pair_local:
        ll, details = _crop_semantic(ll, details, h, w, LEVELS)

    def inverse(target, emit_u8):
        rec, hi = ll, LEVELS
        for k in reversed(_pass_sizes(LEVELS)):
            if hi <= target:
                break
            lo = max(hi - k, target)
            ch, cw = details[hi - 1][0].shape[-2:]
            rec = inv(rec[..., :ch, :cw], details[lo:hi], lo, hi, k, emit_u8 and lo == 0 and from_color is None)
            hi = lo
        rec = rec if from_color is None else from_color(rec)
        rec = rec[..., : -(-h >> target), : -(-w >> target)]
        return torch.clamp(rec, 0, 255).to(torch.uint8) if emit_u8 and rec.dtype != torch.uint8 else rec

    return ll, details, inverse(0, True), inverse(2, False)


def plain_lossless(x, wavelet, color):
    """The lossless codec on K6/K7's plain twins (``plain_cascade``)."""
    from wicca_tpu_torch.core.color import rct_fwd, rct_inv
    from wicca_tpu_torch.ops import dwt53_cuda as lops

    return plain_cascade(
        x, lambda ll, lvl, k: lops.dwt53_multilevel_plain(ll, k, wavelet),
        lambda rec, dets, lo, hi, orig_k, emit_u8: lops.idwt53_multilevel_plain(rec, dets, hi - lo, emit_u8,
                                                                                orig_k=orig_k, filt=wavelet),
        (rct_fwd, rct_inv) if color == "rct" else (None, None), pair_local=wavelet == "haar_int")


def phase_lossless(x):
    """Phase 3b: the depth-5 lossless roundtrip and decode_at_level(st, 2)
    of each LOSSLESS configuration, held to the frame and the plain path.
    Returns each configuration's launch counts and the largest difference
    per kernel (0 when all equal)."""
    from wicca_tpu_torch import decode, decode_at_level, decode_region, encode

    launches, max_abs_err = {}, {"dwt53_multilevel": 0.0, "idwt53_multilevel": 0.0}
    window = (H // 2 - 300, H // 2 + 300, W // 2 - 700, W // 2 + 700)  # crosses tile seams both ways
    for wavelet, color in LOSSLESS:
        what = f"lossless {wavelet} color={color}"
        reset_all_launches()
        st = encode(x, levels=LEVELS, wavelet=wavelet, color=color)
        rec = decode(st, emit_u8=True)
        part = decode_at_level(st, 2)
        torch.cuda.synchronize()
        launches[(wavelet, color)] = read_launches(("dwt53_multilevel", "idwt53_multilevel"), what)
        check_equal(f"{what}: roundtrip vs the frame", rec, x)
        r0, r1, c0, c1 = window
        check_equal(f"{what}: decode_region{window} vs the frame", decode_region(st, *window, emit_u8=True),
                    x[..., r0:r1, c0:c1])
        if wavelet == "legall5.3" and (H, W) == (8704, 6144):  # pass 2's 1088 input rows pad to 1536
            shapes = (tuple(st.ll.shape), tuple(st.details[3][0].shape), tuple(st.details[4][0].shape))
            if shapes != ((3, 384, 192), (3, 768, 384), (3, 384, 192)):
                raise AssertionError(f"{what}: stored shapes {shapes}")
        pll, pdets, prec, ppart = plain_lossless(x, wavelet, color)
        err = check_pairs({
            "dwt53_multilevel": [(f"{what}: ll", st.ll, pll)] + [
                (f"{what}: plane {i}", a, b) for i, (a, b) in enumerate(zip(flat(st.details), flat(pdets)))],
            "idwt53_multilevel": [(f"{what}: reconstruction", rec, prec), (f"{what}: decode_at_level 2", part, ppart)],
        })
        for name, e in err.items():
            max_abs_err[name] = max(max_abs_err[name], e)
    return launches, max_abs_err


def phase_level(x):
    """Phase 3c: K4 -> K5 on the frame as float32 at step 1.0, held to the
    plain twins. Returns the launch counts and each kernel's largest
    difference."""
    from wicca_tpu_torch import ops
    from wicca_tpu_torch.ops import dwt_cuda

    xf = x.float()
    reset_all_launches()
    bands = ops.dwt_level_quant(xf, 1.0)
    rec = ops.idwt_level_dequant(*bands, 1.0)
    torch.cuda.synchronize()
    launches = read_launches(("dwt_level_quant", "idwt_level_dequant"), "the single-level ops")
    pairs = {
        "dwt_level_quant": [(f"level band {i}", a, b)
                            for i, (a, b) in enumerate(zip(bands, dwt_cuda.dwt_level_quant_plain(xf, 1.0)))],
        "idwt_level_dequant": [("level inverse", rec, dwt_cuda.idwt_level_dequant_plain(*bands, 1.0))],
    }
    return launches, check_pairs(pairs)


FLOAT = (("bior4.4", "ict", 2.0), ("bior4.4", "none", 1.0), ("db2", "none", 1.0))  # the first is the headline


def plain_float(x, wavelet, color, gain, spec):
    """The lossy float codec on K8/K9's plain twins (``plain_cascade``; x is
    already a multiple of 2**LEVELS)."""
    from wicca_tpu_torch.core.color import ict_fwd, ict_inv
    from wicca_tpu_torch.ops import dwt97_cuda as fops

    filt = "db2" if wavelet == "db2" else "cdf97"
    fwd_gain, inv_gain = (torch.tensor(g, dtype=torch.float32, device=x.device).reshape(3, 1, 1)
                          for g in ((1.0, 1.0 / gain, 1.0 / gain), (1.0, gain, gain)))

    def steps(lo, hi):
        return tuple(spec.band_steps(i + 1) for i in range(lo, hi))

    return plain_cascade(
        x, lambda ll, lvl, k: fops.dwt97_multilevel_quant_plain(ll, steps(lvl, lvl + k), filt),
        lambda rec, dets, lo, hi, orig_k, emit_u8: fops.idwt97_multilevel_dequant_plain(
            rec, dets, steps(lo, hi), emit_u8, orig_k=orig_k, filt=filt),
        (lambda t: ict_fwd(t) * fwd_gain, lambda t: ict_inv(t * inv_gain)) if color == "ict" else (None, None))


def phase_float(x):
    """Phase 3d: the depth-5 lossy roundtrip and decode_at_level(st, 2) of
    each FLOAT configuration at QuantSpec(1.0), held to the plain path, with
    PSNR > 30 dB. Returns each configuration's launch counts, the largest
    difference per kernel (0 when all equal) and each PSNR."""
    from wicca_tpu_torch import QuantSpec, decode, decode_at_level, decode_region, encode, psnr

    spec = QuantSpec(base_step=1.0)
    launches, max_abs_err, psnrs = {}, {"dwt97_multilevel_quant": 0.0, "idwt97_multilevel_dequant": 0.0}, {}
    window = (H // 2 - 300, H // 2 + 300, W // 2 - 700, W // 2 + 700)  # crosses tile seams both ways
    for wavelet, color, gain in FLOAT:
        what = f"float {wavelet} color={color} chroma_gain={gain}"
        reset_all_launches()
        st = encode(x, levels=LEVELS, spec=spec, wavelet=wavelet, color=color, chroma_gain=gain)
        rec = decode(st, emit_u8=True)
        part = decode_at_level(st, 2)
        torch.cuda.synchronize()
        launches[(wavelet, color)] = read_launches(("dwt97_multilevel_quant", "idwt97_multilevel_dequant"), what)
        r0, r1, c0, c1 = window
        check_equal(f"{what}: decode_region{window} vs the decode", decode_region(st, *window, emit_u8=True),
                    rec[..., r0:r1, c0:c1])
        if (H, W) == (8704, 6144):  # pass 2's 1088 input rows pad to 1536
            shapes = (tuple(st.ll.shape), tuple(st.details[3][0].shape), tuple(st.details[4][0].shape))
            if shapes != ((3, 384, 192), (3, 768, 384), (3, 384, 192)):
                raise AssertionError(f"{what}: stored shapes {shapes}")
        pll, pdets, prec, ppart = plain_float(x, wavelet, color, gain, spec)
        err = check_pairs({
            "dwt97_multilevel_quant": [(f"{what}: ll", st.ll, pll)] + [
                (f"{what}: plane {i}", a, b) for i, (a, b) in enumerate(zip(flat(st.details), flat(pdets)))],
            "idwt97_multilevel_dequant": [(f"{what}: reconstruction", rec, prec),
                                          (f"{what}: decode_at_level 2", part, ppart)],
        })
        for name, e in err.items():
            max_abs_err[name] = max(max_abs_err[name], e)
        psnrs[(wavelet, color)] = float(psnr(rec, x))
        if not psnrs[(wavelet, color)] > 30.0:
            raise AssertionError(f"{what}: roundtrip PSNR {psnrs[(wavelet, color)]} dB <= 30")
    return launches, max_abs_err, psnrs


# ---------------------------------------------------------------------------
# phases 3e-3h: the container, ROI, the 2**31 plane and rate control (after
# phase 3's counters are read: their launches are in no count)
# ---------------------------------------------------------------------------


def sync(t: torch.Tensor) -> None:
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def check_streams(what: str, got, want) -> None:
    """Two streams equal field by field and plane by plane (tolerance 0)."""
    fields = ("spec", "levels", "orig_shape", "wavelet", "color", "chroma_gain", "layout", "bit_depth", "roi_shift",
              "bg_shift", "metadata", "band_div")
    for name in fields:
        if getattr(got, name) != getattr(want, name):
            raise AssertionError(f"{what}: {name} {getattr(got, name)!r} != {getattr(want, name)!r}")
    check_equal(f"{what}: ll", got.ll, want.ll)
    for i, (a, b) in enumerate(zip(flat(got.details), flat(want.details), strict=True)):
        check_equal(f"{what}: plane {i}", a, b)


def prefix_codes(c: torch.Tensor, missing: int, lossless: bool) -> torch.Tensor:
    """The codes a layer prefix missing ``missing`` layers holds: the
    sign-magnitude shift, and for a lossless stream its midpoint widening
    to int32 (the container's rule)."""
    c32 = c.to(torch.int32)
    m = c32.abs() >> missing
    if not lossless:
        return (torch.sign(c32) * m).to(c.dtype)
    return torch.where(m > 0, torch.sign(c32) * ((m << missing) + (1 << (missing - 1))), 0)


CONTAINER = (("haar", "none", 1.0), ("legall5.3", "rct", 1.0), ("bior4.4", "ict", 2.0))


def phase_container(x):
    """Phase 3e: each CONTAINER configuration encoded on the card,
    ``serialize`` (codec 'auto', checksums) and ``deserialize`` onto the
    card: the stream field by field and plane by plane, and its decode bit
    for bit; a 2-layer prefix of a 3-layer file holds the prefix codes and
    decodes as they do; the lossless stream with ``ll_codec='rice'``
    roundtrips; ``inspect(verify=True)`` finds no corrupt unit. Returns the
    host times per configuration."""
    from wicca_tpu_torch import QuantSpec, decode, encode
    from wicca_tpu_torch.codec import container

    spec = QuantSpec(base_step=1.0)
    rows = []
    for wavelet, color, gain in CONTAINER:
        what = f"container {wavelet} color={color}"
        lossless = wavelet == "legall5.3"
        st = encode(x, levels=LEVELS, spec=spec, wavelet=wavelet, color=color, chroma_gain=gain)
        direct = decode(st, emit_u8=True)
        sync(x)
        t0 = time.perf_counter()
        blob = container.serialize(st)
        ser_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = container.deserialize(blob, device=x.device)
        de_s = time.perf_counter() - t0
        check_streams(what, back, st)
        check_equal(f"{what}: decode of the loaded stream", decode(back, emit_u8=True), direct)
        blobs = {"flat": blob}
        t0 = time.perf_counter()
        blobs["layers3"] = container.serialize(st, quality_layers=3)
        ser3_s = time.perf_counter() - t0
        prefix = container.deserialize(blobs["layers3"], max_layers=2, device=x.device)
        want = dataclasses.replace(
            st, details=tuple(tuple(prefix_codes(b, 1, lossless) for b in bands) for bands in st.details),
            spec=spec if lossless else dataclasses.replace(spec, base_step=2 * spec.base_step))
        check_streams(f"{what}: 2-layer prefix", prefix, want)
        check_equal(f"{what}: decode of the 2-layer prefix", decode(prefix, emit_u8=True), decode(want, emit_u8=True))
        if lossless:
            blobs["ll_rice"] = container.serialize(st, ll_codec="rice")
            check_streams(f"{what}: ll_codec='rice'", container.deserialize(blobs["ll_rice"], device=x.device), st)
        for name, b in blobs.items():
            rep = container.inspect(b, verify=True)
            if rep["integrity"] != "ok" or rep["corrupt_sections"]:
                raise AssertionError(f"{what}: inspect({name}) {rep['integrity']} {rep['corrupt_sections']}")
        codecs = [p["codec"] for p in container.inspect(blob)["planes"]]
        rows.append(dict(config=f"{wavelet}/{color}", bytes=len(blob), bpp=8 * len(blob) / (x.shape[-2] * x.shape[-1]),
                         serialize_s=ser_s, deserialize_s=de_s, serialize_layers3_s=ser3_s,
                         source_MB=x.numel() / 1e6, serialize_MBps=x.numel() / 1e6 / ser_s,
                         deserialize_MBps=x.numel() / 1e6 / de_s, rc_planes=codecs.count("rc")))
    return rows


def phase_roi(x):
    """Phase 3f: ``apply_roi`` with a rectangle that crosses tile seams both
    ways, ``bg_shift=2``, on the Haar and ``legall5.3`` + ``rct`` streams;
    ``save`` (a WCT6 file) -> ``load`` -> ``decode`` equal to decoding the
    ROI stream in memory; the region itself decodes as the stream without
    ROI (for the lossless stream: as the frame); ``icon_from_stream`` as the
    plain stream's; ``decode_at_level(st, 2)`` runs. Returns the times of
    ``apply_roi``."""
    import tempfile

    from wicca_tpu_torch import decode, decode_at_level, encode, icon_from_stream
    from wicca_tpu_torch.codec import apply_roi, container

    h, w = x.shape[-2], x.shape[-1]
    r0, r1, c0, c1 = h // 8 + 100, h // 2 + 300, w // 6 + 50, w // 2 + 700  # crosses row and column seams
    mask = np.zeros((h, w), bool)
    mask[r0:r1, c0:c1] = True
    rows = []
    for wavelet, color in (("haar", "none"), ("legall5.3", "rct")):
        what = f"roi {wavelet} color={color}"
        st = encode(x, levels=LEVELS, wavelet=wavelet, color=color)
        sync(x)
        t0 = time.perf_counter()
        roi = apply_roi(st, mask, bg_shift=2)
        sync(x)
        roi_s = time.perf_counter() - t0
        want = decode(roi, emit_u8=True)
        with tempfile.TemporaryDirectory() as tmp:
            path = f"{tmp}/roi.wct"
            nbytes = container.save(roi, path)
            with open(path, "rb") as f:
                if f.read(4) != b"WCT6":
                    raise AssertionError(f"{what}: not a WCT6 file")
            loaded = container.load(path, device=x.device)
        check_streams(f"{what}: loaded", loaded, roi)
        check_equal(f"{what}: decode of the loaded file", decode(loaded, emit_u8=True), want)
        region = x[..., r0:r1, c0:c1] if wavelet == "legall5.3" else decode(st, emit_u8=True)[..., r0:r1, c0:c1]
        check_equal(f"{what}: the region", want[..., r0:r1, c0:c1], region)
        check_equal(f"{what}: icon_from_stream", icon_from_stream(roi), icon_from_stream(st))
        part = decode_at_level(roi, 2)
        if tuple(part.shape) != (x.shape[0], -(-h // 4), -(-w // 4)) or part.dtype != decode_at_level(st, 2).dtype:
            raise AssertionError(f"{what}: decode_at_level(2) gave {part.dtype}{tuple(part.shape)}")
        rows.append(dict(config=f"{wavelet}/{color}", apply_roi_s=roi_s, roi_shift=roi.roi_shift, bytes=nbytes,
                         plain_bytes=len(container.serialize(st))))
    return rows


BIG = 46341  # 46341**2 = 2,147,488,281 samples: past 2**31


def phase_big_plane(seed: int, dev):
    """Phase 3g: a seeded 1 x 46341 x 46341 uint8 plane (2.15 GB) through
    ``encode(levels=5, wavelet='legall5.3')`` and ``decode(emit_u8=True)``
    on the card, equal to the input bit for bit; the level 1-3 codes of a
    tile-aligned crop whose last samples lie past 2**31 equal the plain
    twin's codes of the same crop. Memory: the frame and its 32-multiple
    padding 2.15 GB each, pass 1's level-1 LL (int32) and bands (int16) over
    the tile grid (46592 x 47104) 2.19 + 3.29 GB, decode's int32 level-2
    output 2.19 GB and uint8 output 2.19 GB: about 15 GB at the peak, which
    the phase reports and frees."""
    from wicca_tpu_torch import decode, encode
    from wicca_tpu_torch.core.pad import pad_to_multiple
    from wicca_tpu_torch.ops import dwt53_cuda as lops

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    n = BIG
    x = torch.randint(0, 256, (1, n, n), generator=gen, device=dev, dtype=torch.uint8)
    t0 = time.perf_counter()
    st = encode(x, levels=LEVELS, wavelet="legall5.3")
    rec = decode(st, emit_u8=True)
    sync(x)
    roundtrip_s = time.perf_counter() - t0
    check_equal("2**31 plane: roundtrip vs the input", rec, x)
    del rec
    # tile-aligned (45056, 45056): the crop's last rows lie past sample 2**31
    r0, c0 = (n // 512 - 2) * 512, (n // 1024 - 1) * 1024
    crop = pad_to_multiple(x, 1 << LEVELS)[..., r0:, c0:].contiguous()
    if not r0 * n < 1 << 31 < n * n:
        raise AssertionError("the crop does not straddle sample 2**31")
    _, pdets = lops.dwt53_multilevel_plain(crop, 3)
    for lvl, bands in enumerate(pdets, start=1):
        for i, b in enumerate(bands):
            got = st.details[lvl - 1][i][..., r0 >> lvl : (r0 >> lvl) + b.shape[-2], c0 >> lvl : (c0 >> lvl) + b.shape[-1]]
            check_equal(f"2**31 plane: level {lvl} band {i} of the crop", got, b)
    peak = torch.cuda.max_memory_allocated(dev)
    del x, st, crop, pdets
    torch.cuda.empty_cache()
    return dict(samples=n * n, roundtrip_s=roundtrip_s, peak_GB=peak / 1e9)


def phase_rate_control(x):
    """Phase 3h, on a 3 x 2048 x 2048 crop of the frame (a cut: the step
    search encodes the image once per probe, and PCRD codes every plane once
    per divisor on the host): ``encode_to_bpp(crop, 1.0)`` reaches at most
    1.0 bpp and decodes; ``truncate`` of a step-1.0 stream to 1.0 bpp gives a
    container within that budget that decodes."""
    from wicca_tpu_torch import QuantSpec, decode, encode, psnr
    from wicca_tpu_torch.codec import container, encode_to_bpp, rd_truncate

    crop = x[..., :2048, :2048].contiguous()
    n_px = crop.shape[-2] * crop.shape[-1]
    t0 = time.perf_counter()
    st, info = encode_to_bpp(crop, 1.0)
    search_s = time.perf_counter() - t0
    if not (info["met"] and info["bpp"] <= 1.0):
        raise AssertionError(f"encode_to_bpp missed 1.0 bpp: {info}")
    db_search = float(psnr(decode(st, emit_u8=True), crop))
    fine = encode(crop, levels=LEVELS, spec=QuantSpec(base_step=1.0))
    budget = n_px // 8  # 1.0 bpp
    t0 = time.perf_counter()
    small = rd_truncate(fine, target_bytes=budget)
    truncate_s = time.perf_counter() - t0
    blob = container.serialize(small)
    if len(blob) > budget:
        raise AssertionError(f"truncate: {len(blob)} bytes > the budget of {budget}")
    back = container.deserialize(blob, device=x.device)
    rec = decode(back, emit_u8=True)
    if rec.shape != crop.shape or rec.dtype != torch.uint8:
        raise AssertionError(f"truncate: decode gave {rec.dtype}{tuple(rec.shape)}")
    return dict(search=info, search_s=search_s, search_psnr_db=db_search, truncate_s=truncate_s,
                truncate_bytes=len(blob), budget_bytes=budget, band_div=list(small.band_div),
                truncate_psnr_db=float(psnr(rec, crop)))


# ---------------------------------------------------------------------------
# phase 3i: the folder pipeline at full size (after phase 3's counters are
# read; each folder call reads its own counters)
# ---------------------------------------------------------------------------

# the folder: four frames of bench.py's shape, one that is not a multiple of
# 32 (padded) and one grayscale frame (cv2 reads it as RGB, as the
# reference's loader does)
FOLDER = [(3, H, W)] * 4 + [(3, 4000, 6000), (1, 2048, 2731)]


def _up4(g: np.ndarray) -> np.ndarray:
    """Bilinear 4x upsampling of ``(c, a, b)`` to ``(c, 4(a-1), 4(b-1))``."""
    c, a, b = g.shape
    f = (np.arange(4, dtype=np.float32) + 0.5) / 4
    r = (g[:, :-1, None, :] * (1 - f)[:, None] + g[:, 1:, None, :] * f[:, None]).reshape(c, (a - 1) * 4, b)
    return (r[:, :, :-1, None] * (1 - f) + r[:, :, 1:, None] * f).reshape(c, (a - 1) * 4, (b - 1) * 4)


def photo_like(shape, seed: int) -> np.ndarray:
    """Photograph-like uint8 planar content from ``seed``: a smooth field of
    three octaves (4, 16 and 64 pixels) plus noise, as
    ``tests/test_host_decode.py::photo`` makes with cv2, in numpy. (Pure
    noise is the entropy coders' worst case, left open in PERF.md.)"""
    rng = np.random.default_rng(seed)
    c, h, w = shape

    def noise(a, b, amp):
        return rng.standard_normal((c, a, b), dtype=np.float32) * np.float32(amp)

    hq, wq = h // 4 + 2, w // 4 + 2
    field = noise(hq, wq, 18.0)
    field += _up4(noise(hq // 4 + 2, wq // 4 + 2, 30.0))[:, :hq, :wq]
    field += _up4(_up4(noise(hq // 16 + 3, wq // 16 + 3, 42.0)))[:, :hq, :wq]
    img = _up4(field)[:, :h, :w]
    img += rng.standard_normal((c, h, w), dtype=np.float32) * np.float32(3.0)
    img += np.float32(128.0)
    return np.clip(img, 0, 255).astype(np.uint8)


def write_folder(src, seed: int) -> list:
    """The seeded folder, written as PNG (and a note that the listing must
    leave out); returns each frame as the loader gives it (planar RGB)."""
    import concurrent.futures

    from wicca_tpu_torch.data.pngw import write_png

    src.mkdir()

    def make(i):
        x = photo_like(FOLDER[i], seed + i)
        write_png(str(src / f"frame{i}.png"), x)
        return x if x.shape[0] == 3 else np.repeat(x, 3, axis=0)

    with concurrent.futures.ThreadPoolExecutor(len(FOLDER)) as pool:
        frames = list(pool.map(make, range(len(FOLDER))))
    (src / "notes.txt").write_text("not an image: the folder listing leaves it out\n")
    return frames


def read_pngs(paths) -> list:
    """PNG files read back with cv2 as planar RGB arrays (a pool of reads)."""
    import concurrent.futures

    import cv2

    def read(p):
        a = cv2.imread(str(p), cv2.IMREAD_UNCHANGED)
        if a is None:
            raise AssertionError(f"{p}: cv2 cannot read it")
        return np.moveaxis(cv2.cvtColor(a, cv2.COLOR_BGR2RGB), -1, 0) if a.ndim == 3 else a[None]

    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        return list(pool.map(read, paths))


def folder_call(card: str, dev, what: str, fn, *args, **kw):
    """One folder call on ``dev`` with the launch counters set to 0 just
    before and read just after, under the profiler on a card: its metrics,
    its launches, its wall time and the device's kernel and copy time over
    it (the idle share is the share of the wall time without a kernel)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    reset_all_launches()
    cuda = dev.type == "cuda"
    with profile(activities=[ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        m = fn(*args, device=dev, **kw)
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {k: v for k, v in launch_counts().items() if v}
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    copy_us = sum(e.device_time for e in events if e.name.startswith(("Memcpy", "Memset")))
    kernel_us = sum(e.device_time for e in events) - copy_us
    recorded = sum(1 for e in events if any(sym in e.name for _, _, sym in KERNELS.values()))
    if recorded < sum(launches.values()):
        print(f"  note: the profiler recorded {recorded} of the {sum(launches.values())} launches of {what}")
    row = {"run": what, "metrics": m, "launches": launches, "wall_s": wall, "kernel_ms": kernel_us / 1e3,
           "copy_ms": copy_us / 1e3, "idle_share": 1 - kernel_us / 1e6 / wall}
    print(f"phase 3i [{card}]: {what}: {json.dumps(m)}; launches {json.dumps(launches)}; kernels "
          f"{kernel_us / 1e3:.3f} ms, copies {copy_us / 1e3:.3f} ms over {wall:.3f} s (idle share "
          f"{row['idle_share']:.5f})", flush=True)
    return m, row


def check_launches(what: str, row, want: dict) -> None:
    """The folder call launched exactly ``want`` (absent kernels: none)."""
    if row["launches"] != {k: v for k, v in want.items() if v}:
        raise AssertionError(f"{what}: launches {row['launches']}, expected {want}")


def check_same_files(what: str, a, b, names) -> None:
    for name in names:
        if (a / name).read_bytes() != (b / name).read_bytes():
            raise AssertionError(f"{what}: {a / name} and {b / name} differ")


def check_pixels(what: str, got: list, want: list, tol: int = 0) -> None:
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        w = w.cpu().numpy() if isinstance(w, torch.Tensor) else w
        if g.shape != w.shape or np.abs(g.astype(np.int16) - w.astype(np.int16)).max() > tol:
            raise AssertionError(f"{what}: frame {i} {g.shape} differs from {w.shape} by more than {tol}")


def stage_split(src, tmp, dev) -> dict:
    """One 3 x 8704 x 6144 frame through each stage of the two folder
    routes, timed step by step (host clock around work that ends in a
    wait; CUDA events around the device encode and decode)."""
    from wicca_tpu_torch import QuantSpec, decode, encode
    from wicca_tpu_torch.codec import container, host_decode, host_encode, transfer
    from wicca_tpu_torch.data.loader import load_image, to_planar
    from wicca_tpu_torch.data.pngw import write_png

    spec = QuantSpec(base_step=1.0)
    out = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        r = fn()
        out[name] = time.perf_counter() - t0
        return r

    def events(name, fn):
        if dev.type != "cuda":
            return timed(name, fn)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        r = fn()
        end.record()
        end.synchronize()
        out[name] = start.elapsed_time(end) / 1e3
        return r

    planar = timed("load_s", lambda: to_planar(load_image(src / "frame0.png")))
    x = timed("h2d_s", lambda: transfer.put_array(planar, dev))
    st = events("device_encode_s", lambda: encode(x, levels=LEVELS, spec=spec))
    host = timed("d2h_s", lambda: transfer.fetch_stream(st))
    blob = timed("serialize_s", lambda: container.serialize(host))
    timed("file_write_s", lambda: (tmp / "stage.wct").write_bytes(blob))
    timed("host_encode_s", lambda: host_encode.host_encode(planar, levels=LEVELS, spec=spec))
    data = timed("read_s", lambda: (tmp / "stage.wct").read_bytes())
    back = timed("deserialize_s", lambda: container.deserialize(data, device="cpu"))
    up = timed("decode_h2d_s", lambda: transfer.put_stream(back, dev))
    rec = events("device_decode_s", lambda: decode(up, emit_u8=True))
    arr = timed("decode_d2h_s", lambda: transfer.fetch_array_parallel(rec))
    ncpu = os.cpu_count() or 1
    timed("png_write_s", lambda: write_png(str(tmp / "stage.png"), arr, threads=max(1, ncpu // min(8, ncpu))))
    timed("png_write_all_cores_s", lambda: write_png(str(tmp / "stage.png"), arr))
    timed("host_decode_s", lambda: host_decode.host_decode(back))
    out["frame_bytes"] = planar.nbytes
    out["wct_bytes"] = len(blob)
    if dev.type != "cuda":
        return out
    # the pinned link: one frame's upload and its codes' download, DMA only
    pinned = torch.from_numpy(planar).pin_memory()
    events("h2d_dma_s", lambda: pinned.to(dev, non_blocking=True))
    planes = [st.ll] + flat(st.details)
    sinks = [torch.empty(p.shape, dtype=p.dtype, pin_memory=True) for p in planes]
    events("d2h_dma_s", lambda: [s.copy_(p, non_blocking=True) for s, p in zip(sinks, planes)])
    out["stream_bytes"] = nbytes(*planes)
    out["h2d_GBps"] = planar.nbytes / out["h2d_dma_s"] / 1e9
    out["d2h_GBps"] = out["stream_bytes"] / out["d2h_dma_s"] / 1e9
    return out


def phase_folder(tmp, seed: int, card: str, dev=torch.device("cuda")) -> tuple[dict, list]:
    """Phase 3i, each check fatal: the folder pipeline on a seeded folder of
    photograph-like frames (FOLDER; about 730 MB of uint8 source as PNG),
    written to ``tmp/src`` (phase 3j reads it too); returns the results and
    the frames:
    1. Haar QuantSpec(1.0) depth 5 through ``encode_folder`` with
       ``path='device'`` and ``path='host'``: the same .wct bytes, equal to
       ``serialize(encode(frame))`` in memory; K2 twice per frame on the
       device route, no launch on the host route;
    2. ``decode_folder`` of those files on both routes, in full and at
       ``at_level=2``: the same PNG bytes from both routes, pixels equal to
       ``decode(emit_u8=True)`` and ``decode_at_level(st, 2)``;
    3. ``legall5.3`` + ``rct`` depth 5: the decoded PNGs of both routes equal
       the sources bit for bit;
    4. ``bior4.4`` + ``ict`` (``chroma_gain=2``): ``auto`` sends every frame
       to the device route (no host route takes a tiled float wavelet, so
       ``path='host'`` does too); the PNGs equal the in-memory decode;
    5. ``resume=True`` on the finished Haar folder encodes nothing."""
    from wicca_tpu_torch import QuantSpec, decode, decode_at_level, encode
    from wicca_tpu_torch.codec import batch, container, host_decode, host_encode, transfer

    spec = QuantSpec(base_step=1.0)
    n = len(FOLDER)
    rows = []
    t0 = time.perf_counter()
    frames = write_folder(tmp / "src", seed)
    source_mb = sum(int(np.prod(s)) for s in FOLDER) / 1e6
    print(f"phase 3i [{card}]: folder of {n} PNG frames ({source_mb:.1f} MB of uint8 source, "
          f"{sum(p.stat().st_size for p in (tmp / 'src').glob('*.png')) / 1e6:.1f} MB as PNG) written in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    wct = [f"frame{i}.wct" for i in range(n)]
    png = [f"frame{i}.png" for i in range(n)]

    # 1. Haar encode on both routes
    for route in ("device", "host"):
        m, row = folder_call(card, dev, f"encode haar path={route}", batch.encode_folder, tmp / "src",
                             tmp / f"haar_{route}",
                             levels=LEVELS, spec=spec, path=route)
        rows.append(row)
        if (m["images"], m[f"{route}_encoded"]) != (n, n):
            raise AssertionError(f"haar encode path={route}: {m}")
        check_launches(f"haar encode path={route}", row,
                       {"dwt_multilevel_quant": 2 * n if route == "device" else 0})
    check_same_files("haar .wct across routes", tmp / "haar_device", tmp / "haar_host", wct)
    streams = []
    for i, x in enumerate(frames):
        st = encode(torch.from_numpy(x).to(dev), levels=LEVELS, spec=spec)
        if container.serialize(st) != (tmp / "haar_device" / wct[i]).read_bytes():
            raise AssertionError(f"haar: {wct[i]} differs from serialize(encode(frame)) in memory")
        streams.append(st)

    # 2. Haar decode on both routes, in full and at level 2
    for at in (0, 2):
        for route in ("device", "host"):
            m, row = folder_call(card, dev, f"decode haar at_level={at} path={route}", batch.decode_folder,
                                 tmp / "haar_device", tmp / f"haar_png{at}_{route}", at_level=at, path=route)
            rows.append(row)
            if (m["images"], m[f"{route}_decoded"]) != (n, n):
                raise AssertionError(f"haar decode at_level={at} path={route}: {m}")
            check_launches(f"haar decode at_level={at} path={route}", row,
                           {"idwt_multilevel_dequant": 2 * n if route == "device" else 0})
        check_same_files(f"haar PNGs at_level={at} across routes", tmp / f"haar_png{at}_device",
                         tmp / f"haar_png{at}_host", png)
        want = [decode(st, emit_u8=True) if at == 0 else decode_at_level(st, at, emit_u8=True) for st in streams]
        check_pixels(f"haar PNGs at_level={at}", read_pngs(tmp / f"haar_png{at}_device" / p for p in png), want)
    del streams

    # 3. lossless legall5.3 + rct
    m, row = folder_call(card, dev, "encode legall5.3+rct path=auto", batch.encode_folder, tmp / "src",
                         tmp / "lossless",
                         levels=LEVELS, wavelet="legall5.3", color="rct")
    rows.append(row)
    if m["device_encoded"] != n:
        raise AssertionError(f"legall5.3+rct encode: {m}")
    check_launches("legall5.3+rct encode", row, {"dwt53_multilevel": LEVELS * n})  # one launch per level
    for route in ("device", "host"):
        m, row = folder_call(card, dev, f"decode legall5.3+rct path={route}", batch.decode_folder, tmp / "lossless",
                             tmp / f"lossless_png_{route}", path=route)
        rows.append(row)
        if m[f"{route}_decoded"] != n:
            raise AssertionError(f"legall5.3+rct decode path={route}: {m}")
        check_launches(f"legall5.3+rct decode path={route}", row,
                       {"idwt53_multilevel": LEVELS * n if route == "device" else 0})
    check_same_files("legall5.3+rct PNGs across routes", tmp / "lossless_png_device", tmp / "lossless_png_host",
                     png)
    check_pixels("legall5.3+rct PNGs against the sources", read_pngs(tmp / "lossless_png_device" / p for p in png),
                 frames)

    # 4. lossy bior4.4 + ict, chroma gain 2
    float_kw = dict(levels=LEVELS, spec=spec, wavelet="bior4.4", color="ict", chroma_gain=2.0)
    m, row = folder_call(card, dev, "encode bior4.4+ict path=auto", batch.encode_folder, tmp / "src", tmp / "lossy",
                         **float_kw)
    rows.append(row)
    if m["device_encoded"] != n:
        raise AssertionError(f"bior4.4+ict encode: {m}")
    check_launches("bior4.4+ict encode", row, {"dwt97_multilevel_quant": LEVELS * n})
    want = [decode(encode(torch.from_numpy(x).to(dev), **float_kw), emit_u8=True) for x in frames]
    for route in ("auto", "host"):
        m, row = folder_call(card, dev, f"decode bior4.4+ict path={route}", batch.decode_folder, tmp / "lossy",
                             tmp / f"lossy_png_{route}", path=route)
        rows.append(row)
        if m["device_decoded"] != n:
            raise AssertionError(f"bior4.4+ict decode path={route}: {m}")
        check_launches(f"bior4.4+ict decode path={route}", row, {"idwt97_multilevel_dequant": LEVELS * n})
        check_pixels(f"bior4.4+ict PNGs path={route}", read_pngs(tmp / f"lossy_png_{route}" / p for p in png),
                     want, tol=0 if route == "auto" else 1)
    del want

    # 5. resume on the finished folder
    m, row = folder_call(card, dev, "encode haar resume", batch.encode_folder, tmp / "src", tmp / "haar_device",
                         levels=LEVELS, spec=spec, resume=True)
    rows.append(row)
    if (m["images"], m["resumed"]) != (0, n):
        raise AssertionError(f"resume: {m}")

    stages = stage_split(tmp / "src", tmp, dev)
    rates = {"link_Bps": transfer.link_bandwidth(device=dev), "host_encode_MPs": host_encode.measured_mp_per_s(),
             "host_decode_MPs": {k: host_decode.measured_mp_per_s(k) for k in ("haar", "tiled53")},
             "device_MPs": {k: e.rate() for k, e in batch._device_mps.items()}}
    return {"frames": [list(s) for s in FOLDER], "source_MB": source_mb, "runs": rows, "stages": stages,
            "rates": rates}, frames


# ---------------------------------------------------------------------------
# phase 3j: the classification harness and the model zoo on phase 3i's folder
# (after phase 3's counters are read; each harness run reads its own)
# ---------------------------------------------------------------------------

ZOO = ("SimpleCNN", "MobileNetV2", "ResNet50", "EfficientNetB0", "VGG16", "DenseNet121", "ViTS16")
HARNESS_DEPTHS = (3, 5)
MODEL_SHAPE = (224, 224)
# stated tolerances, relative to the largest |logit| of the float32 model on
# the CPU: the card's float32 (TF32 off) differs only in summation order and
# convolution algorithm (TF32 would miss this by an order of magnitude); the
# zoo's bfloat16 compute keeps top-1 wherever the float32 top-1 margin is
# more than twice BF16_TOL (a few bfloat16 roundings, 2**-8 each, through
# the depth; tests/test_torch_models.py holds the same bound against JAX)
F32_TOL = 1e-4
BF16_TOL = 2e-2


def deterministic_classifier(shape=(32, 32), seed=5):
    """A numpy classifier for byte-equality runs: logits are a fixed random
    projection of the resized pixels (float64, so the BLAS order does not
    reach the float32 logits)."""
    from wicca_tpu_torch.config.constants import DEC_PRED, MODEL, PRE_INP, SHAPE
    from wicca_tpu_torch.models.imagenet import decode_predictions

    w = np.random.default_rng(seed).standard_normal((shape[0] * shape[1] * 3, 1000))

    def model(batch):
        return (np.asarray(batch, np.float64).reshape(len(batch), -1) @ w).astype(np.float32)

    return {MODEL: model, PRE_INP: lambda x: np.asarray(x, np.float32) / 255.0, DEC_PRED: decode_predictions,
            SHAPE: shape}


def icon_launches_expected(frames, depth: int) -> int:
    """K1 launches of one icon batch of ``frames``: one per group of
    same-bucket frames and 512 MB stack chunk (``harness/processor.py``)."""
    from wicca_tpu_torch.harness import processor

    bucket = max(processor._BUCKET, 1 << depth)
    groups: dict = {}
    for f in frames:
        shape = (f.shape[0], -(-f.shape[1] // bucket) * bucket, -(-f.shape[2] // bucket) * bucket)
        groups[shape] = groups.get(shape, 0) + 1
    return sum(-(-n // max(1, processor._MAX_STACK_BYTES // int(np.prod(s)))) for s, n in groups.items())


def harness_run(card: str, dev, what: str, src, out, classifiers, **kw) -> dict:
    """One ``process_classifiers`` run on ``dev`` over ``src`` with the launch
    counters set to 0 just before and read just after, under the profiler on
    a card; fails unless every classifier wrote both CSVs at every depth
    (a disabled classifier writes none). Returns its launches, run metrics
    per depth, wall time and the device's busy time (the union of kernel
    intervals over all streams) and idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from wicca_tpu_torch.analysis.results import result_paths
    from wicca_tpu_torch.harness import ClassifierProcessor

    reset_all_launches()
    cuda = dev.type == "cuda"
    with profile(activities=[ProfilerActivity.CUDA]) if cuda else contextlib.nullcontext() as prof:
        t0 = time.perf_counter()
        proc = ClassifierProcessor(src, transform_depth=HARNESS_DEPTHS, results_folder=out, log_info=False,
                                   device=dev, **kw)
        res = proc.process_classifiers(classifiers)
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {k: v for k, v in launch_counts().items() if v}
    if set(res) != set(classifiers):
        raise AssertionError(f"{what}: classifiers {sorted(set(classifiers) - set(res))} gave no result")
    for depth in HARNESS_DEPTHS:
        for name in classifiers:
            paths = result_paths(out, depth, name)
            if not (paths.regular.is_file() and paths.summary.is_file()):
                raise AssertionError(f"{what}: {name} wrote no CSVs at depth {depth} (disabled)")
    intervals = sorted((e.time_range.start, e.time_range.end) for e in (prof.events() if cuda else [])
                       if e.device_type == DeviceType.CUDA and not e.name.startswith(("Memcpy", "Memset")))
    busy_us, end = 0.0, -math.inf
    for s, e in intervals:
        if e > end:
            busy_us += e - max(s, end)
            end = e
    metrics = {d: json.loads((out / f"depth-{d}" / "run-metrics.json").read_text()) for d in HARNESS_DEPTHS}
    row = {"run": what, "launches": launches, "wall_s": wall, "kernel_busy_ms": busy_us / 1e3,
           "idle_share": 1 - busy_us / 1e6 / wall, "metrics": metrics, "results": res}
    print(f"phase 3j [{card}]: {what}: {wall:.2f} s, launches {json.dumps(launches)}, device busy "
          f"{busy_us / 1e3:.3f} ms (idle share {row['idle_share']:.5f}); per depth "
          + "; ".join(f"{d}: {m['megapixels_per_s']} MP/s over {m['wall_s']} s, stages "
                      f"{json.dumps(m['stage_seconds'])}" for d, m in metrics.items()), flush=True)
    return row


def forward_flops(model, shape, dev) -> int:
    """Operations of one image's forward, counted from the layer shapes:
    2 x the multiply-adds of every convolution and dense layer and of the
    attention products (q k^T and the weighted sum of v)."""
    from wicca_tpu_torch.models import nets

    total = [0]

    def conv(mod, inp, out):
        total[0] += 2 * out.numel() * mod.weight[0].numel()

    def dense(mod, inp, out):
        total[0] += 2 * out.numel() * mod.weight.shape[1]

    def attention(mod, inp, out):
        b, t, dim = inp[0].shape
        total[0] += 2 * 2 * b * t * t * dim

    hooks = [m.register_forward_hook(conv if isinstance(m, nets.Conv) else dense if isinstance(m, nets.Dense)
                                     else attention)
             for m in model.modules() if isinstance(m, (nets.Conv, nets.Dense, nets.MultiHeadDotProductAttention))]
    try:
        with torch.inference_mode():
            model(torch.zeros((1, 3, *shape), device=dev))
    finally:
        for h in hooks:
            h.remove()
    return total[0]


def logits_check(name: str, clf: dict, batch: np.ndarray, dev) -> dict:
    """The zoo model's float32 twin on the card (TF32 off for cuDNN and
    matmuls during the comparison, restored after) against the same module
    on the CPU, and its bfloat16 logits on the card against the CPU's
    float32, on one preprocessed NHWC batch."""
    from wicca_tpu_torch.config.constants import MODEL
    from wicca_tpu_torch.models.registry import build

    zoo = clf[MODEL].module
    state = {k: v.detach().cpu() for k, v in zoo.state_dict().items()}
    cpu = build(name, MODEL_SHAPE, dtype=torch.float32).eval()
    cpu.load_state_dict(state, strict=True)
    card = build(name, MODEL_SHAPE, dtype=torch.float32).eval()
    card.load_state_dict(state, strict=True)
    card = card.to(dev)
    x = torch.from_numpy(np.ascontiguousarray(batch)).permute(0, 3, 1, 2)
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.inference_mode():
            want = cpu(x).numpy()
            got = card(x.to(dev)).cpu().numpy()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    bf16 = clf[MODEL](batch)
    scale = float(np.abs(want).max())
    f32_err = float(np.abs(got - want).max())
    if not np.isfinite(got).all() or f32_err > F32_TOL * scale:
        raise AssertionError(f"{name}: float32 logits on the card differ from the CPU's by {f32_err} "
                             f"(largest |logit| {scale}, tolerance {F32_TOL} of it)")
    top2 = np.sort(want, axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2 * BF16_TOL * scale
    if not np.isfinite(bf16).all() or (bf16.argmax(-1)[clear] != want.argmax(-1)[clear]).any():
        raise AssertionError(f"{name}: bfloat16 top-1 differs from float32 where its margin is clear: "
                             f"{bf16.argmax(-1)} vs {want.argmax(-1)} (clear {clear})")
    if not (got.argmax(-1) == want.argmax(-1)).all():
        raise AssertionError(f"{name}: float32 top-1 on the card differs from the CPU's")
    del card
    return {"f32_max_abs_err": f32_err, "logit_scale": scale, "bf16_max_abs_err": float(np.abs(bf16 - want).max()),
            "bf16_top1_checked": int(clear.sum()),
            "bf16_top1_equal_all": bool((bf16.argmax(-1) == want.argmax(-1)).all())}


def model_times(name: str, clf: dict, batch: np.ndarray, dev, reps: int) -> dict:
    """The zoo model's forward at the harness's batch (CUDA events, median
    of ``reps``; on a device-resident NCHW batch) and its classifier call
    (numpy in, numpy out, the copies included), with operations counted
    from the layer shapes."""
    from wicca_tpu_torch.config.constants import MODEL

    module = clf[MODEL].module
    x = torch.from_numpy(np.ascontiguousarray(batch)).to(dev).permute(0, 3, 1, 2)
    flops = forward_flops(module, MODEL_SHAPE, dev)

    def fwd():
        with torch.inference_mode():
            module(x)

    ms = time_ms(fwd, reps, warmup=3)
    call_ms = time_ms(lambda: clf[MODEL](batch), reps, warmup=1)
    n = len(batch)
    return {"batch": n, "gflop_per_image": flops / 1e9, "forward_ms": ms, "call_ms": call_ms,
            "images_per_s": n / call_ms * 1e3, "forward_images_per_s": n / ms * 1e3,
            "tflop_per_s": flops * n / ms / 1e9}


def phase_harness(src, frames, card: str, dev, reps: int) -> dict:
    """Phase 3j, each check fatal: the port's harness on phase 3i's folder
    (``FOLDER``: four 3x8704x6144 frames, one 3x4000x6000, one grayscale
    2048x2731 read as RGB), ``transform_depth=(3, 5)``, the icon route forced
    to the device (``WICCA_TPU_ICON_PATH=device``):
    1. ``load_models`` of ``ZOO`` at 224x224 on the card: none None, every
       parameter on the card;
    2. a deterministic numpy classifier's run on the card and with
       ``device='cpu'`` (K1's plain twin): the same CSV bytes, K1 launched as
       the bucket groups and stack chunks say; the icons of every frame at
       both depths equal ``icon_host``'s bit for bit;
    3. the zoo run: every classifier writes both CSVs at every depth, K1
       launched as in 2; device idle share over the run;
    4. per model, on one 12-image batch (the six frames and their depth-3
       icons, resized and preprocessed as the harness does): the card's
       float32 logits (TF32 off) against the same module on the CPU within
       F32_TOL, the zoo's bfloat16 top-1 where the float32 margin is clear;
       forward time at the harness's batch, images/s, TFLOP/s;
    5. ``compare='reconstruction'`` with MobileNetV2, Haar ``QuantSpec(1.0)``
       (K2/K3 once per frame per depth-3 roundtrip, twice at depth 5),
       ``legall5.3`` + ``rct`` (K6/K7 once per level; the roundtrip is exact,
       so every image's best class agrees) and ``bior4.4`` + ``ict`` at
       ``QuantSpec(1.0)`` (K8/K9 once per level)."""
    import tempfile
    from pathlib import Path

    from wicca_tpu_torch.config.constants import MODEL, PRE_INP, SHAPE, SIM_BEST_CLASS
    from wicca_tpu_torch.core.icon_host import icon_host
    from wicca_tpu_torch.core.quant import QuantSpec
    from wicca_tpu_torch.harness import processor
    from wicca_tpu_torch.models import load_models

    n = len(frames)
    os.environ["WICCA_TPU_ICON_PATH"] = "device"
    out: dict = {"models": {}}
    try:
        with tempfile.TemporaryDirectory(prefix="wicca_harness_") as tmp:
            tmp = Path(tmp)
            # 1. the zoo on the card
            t0 = time.perf_counter()
            zoo = load_models({name: (name, {"shape": MODEL_SHAPE}) for name in ZOO}, device=dev)
            out["load_s"] = time.perf_counter() - t0
            for name, clf in zoo.items():
                if clf is None:
                    raise AssertionError(f"load_models gave None for {name}")
                where = {p.device.type for p in clf[MODEL].module.parameters()}
                if where != {dev.type}:
                    raise AssertionError(f"{name}: parameters on {where}, not {dev.type}")
            print(f"phase 3j [{card}]: load_models of {len(zoo)} models at {MODEL_SHAPE} on {dev.type} in "
                  f"{out['load_s']:.1f} s", flush=True)
            want_k1 = ({"icon": sum(icon_launches_expected(frames, d) for d in HARNESS_DEPTHS)}
                       if dev.type == "cuda" else {})

            # 2. deterministic classifier: the card's CSVs equal the CPU's; icons equal icon_host's
            det = {"det": deterministic_classifier()}
            row = harness_run(card, dev, "deterministic classifier", src, tmp / "det_card", det)
            if row["launches"] != want_k1:
                raise AssertionError(f"deterministic run launched {row['launches']}, expected {want_k1}")
            out["deterministic"] = {k: row[k] for k in ("launches", "wall_s", "idle_share")}
            cpu_row = harness_run(card, torch.device("cpu"), "deterministic classifier, device='cpu'", src,
                                  tmp / "det_cpu", det)
            if cpu_row["launches"]:
                raise AssertionError(f"the CPU run launched {cpu_row['launches']}")
            for d in HARNESS_DEPTHS:
                for f in (f"det-depth-{d}.csv", f"det-summary-depth-{d}.csv"):
                    if (tmp / "det_card" / f"depth-{d}" / f).read_bytes() != (
                            tmp / "det_cpu" / f"depth-{d}" / f).read_bytes():
                        raise AssertionError(f"{f}: the card's CSV differs from the CPU run's")
            images = [np.ascontiguousarray(np.moveaxis(f, 0, -1)) for f in frames]
            for d in HARNESS_DEPTHS:
                icons = processor._compute_icons_batched(images, d, dev)
                for i, (icon, f) in enumerate(zip(icons, frames)):
                    if not np.array_equal(icon, np.moveaxis(icon_host(f, d), 0, -1)):
                        raise AssertionError(f"frame {i} depth {d}: K1's icon differs from icon_host's")
            print(f"phase 3j [{card}]: deterministic classifier: CSVs of the card and the CPU run equal byte for "
                  f"byte; K1 icons of {n} frames at depths {HARNESS_DEPTHS} equal icon_host's", flush=True)

            # 3. the zoo run
            row = harness_run(card, dev, f"zoo {','.join(ZOO)}", src, tmp / "zoo", zoo)
            if row["launches"] != want_k1:
                raise AssertionError(f"zoo run launched {row['launches']}, expected {want_k1}")
            out["zoo"] = {k: row[k] for k in ("launches", "wall_s", "kernel_busy_ms", "idle_share", "metrics")}
            out["zoo"]["mean_best_class"] = {k: float(v[1].loc["mean", SIM_BEST_CLASS]) for k, v in
                                             row["results"].items()}

            # 4. per model: logits against the CPU, times
            import cv2

            icons3 = processor._compute_icons_batched(images, 3, dev)
            for name, clf in zoo.items():
                stack = np.stack([cv2.resize(im, clf[SHAPE], interpolation=3) for im in images + icons3])
                batch = np.asarray(clf[PRE_INP](stack), dtype=np.float32)
                check = logits_check(name, clf, batch, dev)
                times = model_times(name, clf, batch[:n], dev, reps) if dev.type == "cuda" else {}
                out["models"][name] = {**check, **times}
                print(f"phase 3j [{card}]: {name}: {json.dumps(out['models'][name])}", flush=True)

            # 5. reconstruction runs with MobileNetV2
            mnv2 = {"MobileNetV2": zoo["MobileNetV2"]}
            for what, kw, want in (
                ("reconstruction haar", dict(compare="reconstruction", codec_spec=QuantSpec(base_step=1.0)),
                 {"dwt_multilevel_quant": 3 * n, "idwt_multilevel_dequant": 3 * n}),
                ("reconstruction legall5.3+rct", dict(compare="reconstruction", codec_wavelet="legall5.3",
                                                      codec_color="rct"),
                 {"dwt53_multilevel": sum(HARNESS_DEPTHS) * n, "idwt53_multilevel": sum(HARNESS_DEPTHS) * n}),
                ("reconstruction bior4.4+ict", dict(compare="reconstruction", codec_spec=QuantSpec(base_step=1.0),
                                                   codec_wavelet="bior4.4", codec_color="ict"),
                 {"dwt97_multilevel_quant": sum(HARNESS_DEPTHS) * n,
                  "idwt97_multilevel_dequant": sum(HARNESS_DEPTHS) * n}),
            ):
                row = harness_run(card, dev, what, src, tmp / what.replace(" ", "_"), mnv2, **kw)
                if row["launches"] != (want if dev.type == "cuda" else {}):
                    raise AssertionError(f"{what}: launches {row['launches']}, expected {want}")
                best = float(row["results"]["MobileNetV2"][1].loc["mean", SIM_BEST_CLASS])
                if "legall" in what and best != 100.0:
                    raise AssertionError(f"{what}: the exact roundtrip's best class agrees in {best}% only")
                out[what] = {k: row[k] for k in ("launches", "wall_s", "kernel_busy_ms", "idle_share")}
                out[what]["mean_best_class"] = best
            del zoo
    finally:
        del os.environ["WICCA_TPU_ICON_PATH"]
    return out


# ---------------------------------------------------------------------------
# phase 4: times at the main-path shapes
# ---------------------------------------------------------------------------


def lifting_ops(n: int, k: int) -> float:
    """Integer operations of k lifting levels over n input samples: about 8
    per sample per level (two lifting steps in each direction)."""
    return 8 * n * sum(0.25**i for i in range(k))


def float_lifting_ops(n: int, k: int) -> float:
    """Float operations of k 9/7 levels over n input samples: about 16 per
    sample per level (four lifting steps and the scaling in each direction,
    and the quantizer)."""
    return 16 * n * sum(0.25**i for i in range(k))


def time_passes(passes, reps, rate):
    """Rows of times for ``(kernel, pass, kernel call, plain call, bytes
    moved, operations, runs)`` tuples; ``runs``: how many times the pass
    runs in the main-path run whose launches the ``kernels`` line counts
    (0: timed beside it), the weight of the pass in the kernel's totals."""
    rows = []
    for name, label, kern, plain, b, ops_count, runs in passes:
        reset_all_launches()
        kern()
        launches = launch_counts()[name]
        call_ms = time_ms(kern, reps)  # CUDA events around the wrapper call: host + device
        ms = device_ms(kern, reps, KERNELS[name][2], launches)
        rows.append(dict(kernel=name, part=label, runs=runs, launches=launches, ms=call_ms if ms is None else ms,
                         timing="cuda events" if ms is None else "profiler device time", call_ms=call_ms,
                         plain_ms=time_ms(plain, max(10, reps // 2), warmup=1), bytes=b, operations=ops_count,
                         bytes_ms=b / rate * 1e3, operations_ms=ops_count / F32_PEAK * 1e3))
    return rows


def haar_passes(x):
    """K1-K3 at the Haar main path's shapes."""
    from wicca_tpu_torch import QuantSpec
    from wicca_tpu_torch.ops import dwt_cuda as ops

    spec = QuantSpec(base_step=1.0)
    s13 = tuple(spec.band_steps(i) for i in (1, 2, 3))
    s45 = tuple(spec.band_steps(i) for i in (4, 5))
    ll3, dets13 = ops.dwt_multilevel_quant(x, s13)
    ll5, dets45 = ops.dwt_multilevel_quant(ll3, s45)
    rec3 = ops.idwt_multilevel_dequant(ll5, dets45, s45)
    out = ops.idwt_multilevel_dequant(rec3, dets13, s13, emit_u8=True)
    icon = ops.icon(x, LEVELS)
    # bytes count each input read once and each output written once;
    # operations are the arithmetic per sample the pass needs (1 add per
    # icon input byte; ~8 per forward and ~12 per inverse sample)
    n = x.numel()
    return [
        ("icon", "depth 5", lambda: ops.icon(x, LEVELS), lambda: ops.icon_plain(x, LEVELS),
         nbytes(x, icon), n, 1),
        ("dwt_multilevel_quant", "levels 1-3 from u8", lambda: ops.dwt_multilevel_quant(x, s13),
         lambda: ops.dwt_multilevel_quant_plain(x, s13), nbytes(x, ll3, *flat(dets13)), 8 * n, 1),
        ("dwt_multilevel_quant", "levels 4-5 from f32", lambda: ops.dwt_multilevel_quant(ll3, s45),
         lambda: ops.dwt_multilevel_quant_plain(ll3, s45), nbytes(ll3, ll5, *flat(dets45)), 8 * ll3.numel(), 1),
        ("idwt_multilevel_dequant", "levels 5-4 to f32",
         lambda: ops.idwt_multilevel_dequant(ll5, dets45, s45),
         lambda: ops.idwt_multilevel_dequant_plain(ll5, dets45, s45),
         nbytes(ll5, rec3, *flat(dets45)), 12 * rec3.numel(), 1),
        ("idwt_multilevel_dequant", "levels 3-1 to u8",
         lambda: ops.idwt_multilevel_dequant(rec3, dets13, s13, emit_u8=True),
         lambda: ops.idwt_multilevel_dequant_plain(rec3, dets13, s13, emit_u8=True),
         nbytes(rec3, out, *flat(dets13)), 12 * out.numel(), 1),
    ]


def level_passes(x):
    """K4/K5 on the frame as float32 at step 1.0 (int8 codes)."""
    from wicca_tpu_torch.ops import dwt_cuda as ops

    xf = x.float()
    bands = ops.dwt_level_quant(xf, 1.0)
    rec = ops.idwt_level_dequant(*bands, 1.0)
    return [
        ("dwt_level_quant", "level 1 from f32", lambda: ops.dwt_level_quant(xf, 1.0),
         lambda: ops.dwt_level_quant_plain(xf, 1.0), nbytes(xf, *bands), 5 * xf.numel(), 1),
        ("idwt_level_dequant", "level 1 to f32", lambda: ops.idwt_level_dequant(*bands, 1.0),
         lambda: ops.idwt_level_dequant_plain(*bands, 1.0), nbytes(*bands, rec), 6 * rec.numel(), 1),
    ]


def lifting_passes(x):
    """K6/K7 at the lossless path's shapes. The headline (legall5.3, rct)
    run is encode, decode and decode_at_level(st, 2): K6 runs its two passes
    once, the first from the uint8 frame with the RCT folded into its first
    launch; K7 runs levels 5-4 twice (in decode and in decode_at_level),
    levels 3-1 to uint8 with the inverse RCT folded into its last launch
    once, and the partial level 3 of 3 (to int32, with the inverse RCT) once.
    Timed beside them: the uint8 regimes of color='none', and the passes
    from and to int32 that PR 4's design ran for `rct`."""
    from wicca_tpu_torch.core.color import rct_fwd
    from wicca_tpu_torch.ops import dwt53_cuda as lops

    rct = dict(color="rct")
    ll3, d13 = lops.dwt53_multilevel(x, 3, **rct)
    ll5, d45 = lops.dwt53_multilevel(ll3, 2)
    full = lops.idwt53_multilevel(ll5, d45, 2)
    rec3 = full[..., : ll3.shape[-2], : ll3.shape[-1]].contiguous()
    rec = lops.idwt53_multilevel(rec3, d13, 3, emit_u8=True, **rct)
    part = lops.idwt53_multilevel(rec3, d13[2:], 1, orig_k=3, **rct)
    yuv = rct_fwd(x)
    fll3, fd13 = lops.dwt53_multilevel(yuv, 3)
    frec = lops.idwt53_multilevel(fll3, fd13, 3)
    ull3, ud13 = lops.dwt53_multilevel(x, 3)
    urec = lops.idwt53_multilevel(ull3, ud13, 3, emit_u8=True)
    n = x.numel()
    rct_ops = 4 * n  # about four integer operations per sample each way
    return [
        ("dwt53_multilevel", "levels 1-3 from u8 + RCT (`rct`)", lambda: lops.dwt53_multilevel(x, 3, **rct),
         lambda: lops.dwt53_multilevel_plain(x, 3, **rct), nbytes(x, ll3, *flat(d13)),
         lifting_ops(n, 3) + rct_ops, 1),
        ("dwt53_multilevel", "levels 4-5 from i32", lambda: lops.dwt53_multilevel(ll3, 2),
         lambda: lops.dwt53_multilevel_plain(ll3, 2), nbytes(ll3, ll5, *flat(d45)), lifting_ops(ll3.numel(), 2),
         1),
        ("dwt53_multilevel", "levels 1-3 from u8 (`none`)", lambda: lops.dwt53_multilevel(x, 3),
         lambda: lops.dwt53_multilevel_plain(x, 3), nbytes(x, ull3, *flat(ud13)), lifting_ops(n, 3), 0),
        ("dwt53_multilevel", "levels 1-3 from i32", lambda: lops.dwt53_multilevel(yuv, 3),
         lambda: lops.dwt53_multilevel_plain(yuv, 3), nbytes(yuv, fll3, *flat(fd13)), lifting_ops(n, 3), 0),
        ("idwt53_multilevel", "levels 5-4 to i32", lambda: lops.idwt53_multilevel(ll5, d45, 2),
         lambda: lops.idwt53_multilevel_plain(ll5, d45, 2), nbytes(ll5, full, *flat(d45)),
         lifting_ops(full.numel(), 2), 2),
        ("idwt53_multilevel", "levels 3-1 + RCT to u8 (`rct`)",
         lambda: lops.idwt53_multilevel(rec3, d13, 3, emit_u8=True, **rct),
         lambda: lops.idwt53_multilevel_plain(rec3, d13, 3, emit_u8=True, **rct), nbytes(rec3, rec, *flat(d13)),
         lifting_ops(rec.numel(), 3) + rct_ops, 1),
        ("idwt53_multilevel", "levels 3-1 to u8 (`none`)", lambda: lops.idwt53_multilevel(ull3, ud13, 3, emit_u8=True),
         lambda: lops.idwt53_multilevel_plain(ull3, ud13, 3, emit_u8=True), nbytes(ull3, urec, *flat(ud13)),
         lifting_ops(urec.numel(), 3), 0),
        ("idwt53_multilevel", "levels 3-1 to i32", lambda: lops.idwt53_multilevel(fll3, fd13, 3),
         lambda: lops.idwt53_multilevel_plain(fll3, fd13, 3), nbytes(fll3, frec, *flat(fd13)),
         lifting_ops(frec.numel(), 3), 0),
        ("idwt53_multilevel", "level 3 of 3, orig_k + RCT (`decode_at_level`)",
         lambda: lops.idwt53_multilevel(rec3, d13[2:], 1, orig_k=3, **rct),
         lambda: lops.idwt53_multilevel_plain(rec3, d13[2:], 1, orig_k=3, **rct), nbytes(rec3, part, *flat(d13[2:])),
         lifting_ops(part.numel(), 1) + 4 * part.numel(), 1),
    ]


def float_passes(x):
    """K8/K9 at the lossy float path's shapes. The headline (bior4.4, ict,
    chroma_gain 2) run is encode, decode and decode_at_level(st, 2): K8 runs
    its two passes once, the first from the uint8 frame with the ICT folded
    into its first launch; K9 runs levels 5-4 twice, levels 3-1 to uint8
    with the inverse ICT folded into its last launch once, and the partial
    level 3 of 3 (to float32, with the inverse ICT) once. Timed beside them:
    the uint8 regimes of color='none', and the passes from and to float32
    that PR 3's design ran for `ict`."""
    from wicca_tpu_torch import QuantSpec
    from wicca_tpu_torch.core.color import ict_fwd_codec
    from wicca_tpu_torch.ops import dwt97_cuda as fops

    spec = QuantSpec(base_step=1.0)
    s13 = tuple(spec.band_steps(i) for i in (1, 2, 3))
    s45 = tuple(spec.band_steps(i) for i in (4, 5))
    ict = ("ict", 2.0)
    ll3, d13 = fops.dwt97_multilevel_quant(x, s13, "cdf97", *ict)
    ll5, d45 = fops.dwt97_multilevel_quant(ll3, s45)
    full = fops.idwt97_multilevel_dequant(ll5, d45, s45)
    rec3 = full[..., : ll3.shape[-2], : ll3.shape[-1]].contiguous()
    rec = fops.idwt97_multilevel_dequant(rec3, d13, s13, True, None, "cdf97", 0.5, *ict)
    part = fops.idwt97_multilevel_dequant(rec3, d13[2:], s13[2:], False, 3, "cdf97", 0.5, *ict)
    yuv = ict_fwd_codec(x, 2.0)
    fll3, fd13 = fops.dwt97_multilevel_quant(yuv, s13)
    frec = fops.idwt97_multilevel_dequant(fll3, fd13, s13)
    ull3, ud13 = fops.dwt97_multilevel_quant(x, s13)
    urec = fops.idwt97_multilevel_dequant(ull3, ud13, s13, emit_u8=True)
    n = x.numel()
    ict_ops = 6 * n  # three products, two sums and the chroma product per sample
    return [
        ("dwt97_multilevel_quant", "levels 1-3 from u8 + ICT (`ict`)",
         lambda: fops.dwt97_multilevel_quant(x, s13, "cdf97", *ict),
         lambda: fops.dwt97_multilevel_quant_plain(x, s13, "cdf97", *ict), nbytes(x, ll3, *flat(d13)),
         float_lifting_ops(n, 3) + ict_ops, 1),
        ("dwt97_multilevel_quant", "levels 4-5 from f32", lambda: fops.dwt97_multilevel_quant(ll3, s45),
         lambda: fops.dwt97_multilevel_quant_plain(ll3, s45), nbytes(ll3, ll5, *flat(d45)),
         float_lifting_ops(ll3.numel(), 2), 1),
        ("dwt97_multilevel_quant", "levels 1-3 from u8 (`none`)", lambda: fops.dwt97_multilevel_quant(x, s13),
         lambda: fops.dwt97_multilevel_quant_plain(x, s13), nbytes(x, ull3, *flat(ud13)),
         float_lifting_ops(n, 3), 0),
        ("dwt97_multilevel_quant", "levels 1-3 from f32", lambda: fops.dwt97_multilevel_quant(yuv, s13),
         lambda: fops.dwt97_multilevel_quant_plain(yuv, s13), nbytes(yuv, fll3, *flat(fd13)),
         float_lifting_ops(n, 3), 0),
        ("idwt97_multilevel_dequant", "levels 5-4 to f32",
         lambda: fops.idwt97_multilevel_dequant(ll5, d45, s45),
         lambda: fops.idwt97_multilevel_dequant_plain(ll5, d45, s45), nbytes(ll5, full, *flat(d45)),
         float_lifting_ops(full.numel(), 2), 2),
        ("idwt97_multilevel_dequant", "levels 3-1 + ICT to u8 (`ict`)",
         lambda: fops.idwt97_multilevel_dequant(rec3, d13, s13, True, None, "cdf97", 0.5, *ict),
         lambda: fops.idwt97_multilevel_dequant_plain(rec3, d13, s13, True, None, "cdf97", 0.5, *ict),
         nbytes(rec3, rec, *flat(d13)), float_lifting_ops(rec.numel(), 3) + ict_ops, 1),
        ("idwt97_multilevel_dequant", "levels 3-1 to u8 (`none`)",
         lambda: fops.idwt97_multilevel_dequant(ull3, ud13, s13, emit_u8=True),
         lambda: fops.idwt97_multilevel_dequant_plain(ull3, ud13, s13, emit_u8=True),
         nbytes(ull3, urec, *flat(ud13)), float_lifting_ops(urec.numel(), 3), 0),
        ("idwt97_multilevel_dequant", "levels 3-1 to f32",
         lambda: fops.idwt97_multilevel_dequant(fll3, fd13, s13),
         lambda: fops.idwt97_multilevel_dequant_plain(fll3, fd13, s13),
         nbytes(fll3, frec, *flat(fd13)), float_lifting_ops(frec.numel(), 3), 0),
        ("idwt97_multilevel_dequant", "level 3 of 3, orig_k + ICT (`decode_at_level`)",
         lambda: fops.idwt97_multilevel_dequant(rec3, d13[2:], s13[2:], False, 3, "cdf97", 0.5, *ict),
         lambda: fops.idwt97_multilevel_dequant_plain(rec3, d13[2:], s13[2:], False, 3, "cdf97", 0.5, *ict),
         nbytes(rec3, part, *flat(d13[2:])), float_lifting_ops(part.numel(), 1) + 6 * part.numel(), 1),
    ]


def roundtrip_times(fn, reps):
    """A roundtrip called alone and back to back, its device-busy time and
    the idle shares."""
    alone_ms = time_ms(fn, reps)
    stream_ms = loop_ms(fn, reps)
    busy_ms = device_ms(fn, reps)
    mp = H * W / 1e6
    return {
        "alone_ms": alone_ms, "alone_MPs": mp / alone_ms * 1e3, "device_busy_ms": busy_ms,
        "alone_idle_share": None if busy_ms is None else 1 - busy_ms / alone_ms,
        "back_to_back_ms": stream_ms, "back_to_back_MPs": mp / stream_ms * 1e3,
        "back_to_back_idle_share": None if busy_ms is None else 1 - busy_ms / stream_ms,
    }


def phase_times(x, launches, max_abs_err, reps, rate):
    from wicca_tpu_torch import HaarCoder, QuantSpec, decode, encode
    from wicca_tpu_torch.ops import dwt_cuda as ops

    rows = time_passes(haar_passes(x) + level_passes(x) + lifting_passes(x) + float_passes(x), reps, rate)
    library = {"icon": time_ms(lambda: torch.nn.functional.avg_pool2d(x.float(), 32), reps)}
    kernels = []
    for name, (replaces, source, _) in KERNELS.items():
        mine = [r for r in rows if r["kernel"] == name]
        if sum(r["launches"] * r["runs"] for r in mine) != launches[name]:
            raise AssertionError(f"{name}: the timed passes do not add up to the main path's {launches[name]} "
                                 f"launches: {[(r['part'], r['launches'], r['runs']) for r in mine]}")
        bytes_ms = sum(r["bytes_ms"] * r["runs"] for r in mine)
        ops_ms = sum(r["operations_ms"] * r["runs"] for r in mine)
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": max_abs_err[name],
            "ms": sum(r["ms"] * r["runs"] for r in mine), "plain_ms": sum(r["plain_ms"] * r["runs"] for r in mine),
            "bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": library.get(name),
        })

    spec = QuantSpec(base_step=1.0)
    mp = H * W / 1e6
    icon_ms = time_ms(lambda: ops.icon(x, LEVELS), reps)
    hwc = x.permute(1, 2, 0)
    e2e = {
        "haar_roundtrip_depth5": roundtrip_times(lambda: decode(encode(x, levels=LEVELS, spec=spec), emit_u8=True),
                                                 reps),
        "haar_roundtrip_bytes": sum(r["bytes"] for r in rows if r["kernel"] in ("dwt_multilevel_quant",
                                                                              "idwt_multilevel_dequant")),
        "icon_depth5_ms": icon_ms, "icon_depth5_MPs": mp / icon_ms * 1e3,
        "get_small_copy_hwc_tensor_ms": time_ms(lambda: HaarCoder().get_small_copy(hwc, LEVELS), reps),
    }
    for color in ("rct", "none"):
        e2e[f"lossless_{color}_roundtrip_depth5"] = roundtrip_times(
            lambda c=color: decode(encode(x, levels=LEVELS, wavelet="legall5.3", color=c), emit_u8=True), reps)
    e2e["lossless_rct_roundtrip_bytes"] = sum(r["bytes"] for r in rows
                                              if r["kernel"] in ("dwt53_multilevel", "idwt53_multilevel") and r["runs"]
                                              and "decode_at_level" not in r["part"])
    for color, gain in (("ict", 2.0), ("none", 1.0)):
        e2e[f"float_{color}_roundtrip_depth5"] = roundtrip_times(
            lambda c=color, g=gain: decode(encode(x, levels=LEVELS, spec=spec, wavelet="bior4.4", color=c,
                                                  chroma_gain=g), emit_u8=True), reps)
    # one K8 pass each of levels 1-3 and 4-5, one K9 pass each of 5-4 and 3-1
    e2e["float_ict_roundtrip_bytes"] = sum(r["bytes"] for r in rows if r["kernel"] in (
        "dwt97_multilevel_quant", "idwt97_multilevel_dequant") and r["runs"] and "decode_at_level" not in r["part"])
    return rows, kernels, e2e


def print_folder(folder: dict, card: str, cpu: str, t0: float) -> None:
    st = folder["stages"]
    print(f"phase 3i [{card}; host {cpu}]: one 3x{H}x{W} frame, encode: load {st['load_s']:.3f} s, H2D "
          f"{st['h2d_s']:.4f} s, device encode {st['device_encode_s']:.4f} s, D2H {st['d2h_s']:.4f} s, serialize "
          f"{st['serialize_s']:.3f} s, file write {st['file_write_s']:.3f} s (host encode "
          f"{st['host_encode_s']:.3f} s); decode: read {st['read_s']:.3f} s, deserialize "
          f"{st['deserialize_s']:.3f} s, H2D {st['decode_h2d_s']:.4f} s, "
          f"device decode {st['device_decode_s']:.4f} s, D2H {st['decode_d2h_s']:.4f} s, PNG write "
          f"{st['png_write_s']:.3f} s ({st['png_write_all_cores_s']:.3f} s on all cores) (host decode "
          f"{st['host_decode_s']:.3f} s)", flush=True)
    print(f"phase 3i [{card}]: pinned link: H2D {st['h2d_GBps']:.2f} GB/s ({st['frame_bytes']} bytes), D2H "
          f"{st['d2h_GBps']:.2f} GB/s ({st['stream_bytes']} bytes), the cost model's link EMA "
          f"{folder['rates']['link_Bps'] / 1e9:.2f} GB/s; rates {json.dumps(folder['rates'])} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)


def host_cpu() -> str:
    """The host CPU as ``lscpu`` names it (vendor, model, BIOS model) and
    the cores this process may use."""
    out = subprocess.run(["lscpu"], capture_output=True, text=True, timeout=60).stdout
    fields = dict(line.split(":", 1) for line in out.splitlines() if ":" in line)
    names = [fields[k].strip() for k in ("Vendor ID", "Model name", "BIOS Model name") if k in fields]
    return f"{' / '.join(names) or 'not reported'}, {len(os.sched_getaffinity(0))} cores usable"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to drive", file=sys.stderr)
        return 1
    from wicca_tpu_torch.ops import _build

    # phase 1: card, versions, build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}", flush=True)
    t0 = time.perf_counter()
    _build.library()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s (nvcc {_build.build_seconds})", flush=True)
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", _build.build_log)]
    spills = sum(int(b) for b in re.findall(r"(\d+) bytes spill stores", _build.build_log))
    if regs:
        print(f"  ptxas: {len(regs)} kernels, {min(regs)}-{max(regs)} registers, {spills} bytes spill stores")
    from wicca_tpu_torch.native import rice

    t0 = time.perf_counter()
    rice.library()  # the container's entropy coders (g++), so that phase 3e times coding alone
    print(f"entropy library build: {time.perf_counter() - t0:.1f} s", flush=True)
    from wicca_tpu_torch.native import idwt, pngw

    for what, lib in (("host IDWT library (idwt.cpp)", idwt), ("PNG writer library (pngw.cpp, -lz)", pngw)):
        t0 = time.perf_counter()
        lib.library()  # the folder pipeline's host route and writer, so that phase 3i times them alone
        print(f"{what} build: {time.perf_counter() - t0:.1f} s", flush=True)
    name = torch.cuda.get_device_name(0)
    rate = hbm_bytes_per_s(name)

    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    n = phase_kernels_vs_plain(rng, torch.device("cuda"))
    print(f"phase 2: {n} kernel-vs-plain cases equal ({time.perf_counter() - t0:.1f} s)", flush=True)

    t0 = time.perf_counter()
    frame = rng.integers(0, 256, size=(3, H, W), dtype=np.uint8)
    x, launches, max_abs_err, db = phase_main_path(frame, torch.device("cuda"))
    print(f"phase 3a: 3x{H}x{W} depth {LEVELS}: icon, LL, {3 * LEVELS} code planes and reconstruction equal "
          f"the plain path; PSNR {db:.4f} dB; launches {json.dumps(launches)} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    t0 = time.perf_counter()
    lossless_launches, err = phase_lossless(x)
    for (wavelet, color), counts in lossless_launches.items():
        print(f"phase 3b: lossless {wavelet} color={color} depth {LEVELS}: decode equals the frame bit for bit; "
              f"LL, {3 * LEVELS} planes and decode_at_level(2) equal the plain path; launches {json.dumps(counts)}",
              flush=True)
    print(f"phase 3b: {time.perf_counter() - t0:.1f} s", flush=True)
    launches.update(lossless_launches[LOSSLESS[0]])
    max_abs_err.update(err)

    t0 = time.perf_counter()
    level_launches, err = phase_level(x)
    print(f"phase 3c: dwt_level_quant -> idwt_level_dequant on the frame as float32 equal the plain twins; "
          f"launches {json.dumps(level_launches)} ({time.perf_counter() - t0:.1f} s)", flush=True)
    launches.update(level_launches)
    max_abs_err.update(err)

    t0 = time.perf_counter()
    float_launches, err, psnrs = phase_float(x)
    for (wavelet, color), counts in float_launches.items():
        print(f"phase 3d: lossy {wavelet} color={color} depth {LEVELS}: LL, {3 * LEVELS} planes, decode(emit_u8) "
              f"and decode_at_level(2) equal the plain path; PSNR {psnrs[(wavelet, color)]:.4f} dB; "
              f"launches {json.dumps(counts)}", flush=True)
    print(f"phase 3d: {time.perf_counter() - t0:.1f} s", flush=True)
    launches.update(float_launches[(FLOAT[0][0], FLOAT[0][1])])
    max_abs_err.update(err)

    cpu = host_cpu()
    print(f"host CPU: {cpu}", flush=True)
    t0 = time.perf_counter()
    container_rows = phase_container(x)
    for r in container_rows:
        print(f"phase 3e: .wct {r['config']}: the loaded stream and its decode equal the encoded ones; 2-layer "
              f"prefix, inspect ok; {r['bytes']} bytes ({r['bpp']:.4f} bpp, {r['rc_planes']} rc planes); "
              f"serialize {r['serialize_s']:.3f} s ({r['serialize_MBps']:.1f} source MB/s), deserialize "
              f"{r['deserialize_s']:.3f} s ({r['deserialize_MBps']:.1f} source MB/s), 3 layers "
              f"{r['serialize_layers3_s']:.3f} s", flush=True)
    print(f"phase 3e: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    roi_rows = phase_roi(x)
    for r in roi_rows:
        print(f"phase 3f: ROI {r['config']}: WCT6 file, region, icon and decode_at_level(2) hold; apply_roi "
              f"{r['apply_roi_s']:.3f} s, roi_shift {r['roi_shift']}, {r['bytes']} bytes (without ROI "
              f"{r['plain_bytes']})", flush=True)
    print(f"phase 3f: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    big = phase_big_plane(args.seed, x.device)
    print(f"phase 3g: 1x{BIG}x{BIG} legall5.3 depth {LEVELS} ({big['samples']} samples) roundtrips bit for bit, "
          f"codes past 2**31 equal the plain twin's; roundtrip {big['roundtrip_s']:.3f} s, peak "
          f"{big['peak_GB']:.2f} GB ({time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    rc = phase_rate_control(x)
    print(f"phase 3h: encode_to_bpp(3x2048x2048, 1.0) {json.dumps(rc['search'])} in {rc['search_s']:.2f} s, "
          f"PSNR {rc['search_psnr_db']:.4f} dB; truncate to {rc['budget_bytes']} bytes: {rc['truncate_bytes']} "
          f"in {rc['truncate_s']:.2f} s, PSNR {rc['truncate_psnr_db']:.4f} dB ({time.perf_counter() - t0:.1f} s)",
          flush=True)

    rows, kernels, e2e = phase_times(x, launches, max_abs_err, args.reps, rate)
    # phase 3i after phase 4's timings: its profiler sessions would cost
    # phase 4's profiler records
    import tempfile
    from pathlib import Path

    with tempfile.TemporaryDirectory(prefix="wicca_folder_") as tmp:
        t0 = time.perf_counter()
        folder, frames = phase_folder(Path(tmp), args.seed, card)
        print_folder(folder, card, cpu, t0)
        t0 = time.perf_counter()
        harness = phase_harness(Path(tmp) / "src", frames, card, torch.device("cuda"), args.reps)
        print(f"phase 3j [{card}; host {cpu}]: {time.perf_counter() - t0:.1f} s", flush=True)
        del frames

    for r in rows:
        print(f"  {r['kernel']:<25} {r['part']:<49} x{r['runs']} {r['ms']:.4f} ms ({r['timing']}; "
              f"call {r['call_ms']:.4f} ms)  plain {r['plain_ms']:.4f} ms  {r['bytes'] / 1e6:.1f} MB  "
              f"bound {r['bytes_ms']:.4f} ms  {r['bytes'] / r['ms'] / 1e6:.0f} GB/s")
    host = {"cpu": cpu, "container": container_rows, "roi": roi_rows, "big_plane": big, "rate_control": rc,
            "folder": folder, "harness": harness}
    print(json.dumps({"card": card, "hbm_bytes_per_s": rate, "passes": rows, "end_to_end": e2e, "host": host}))
    print(json.dumps({"kernels": kernels}))
    device = {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
