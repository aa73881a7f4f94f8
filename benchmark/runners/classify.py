"""The analysis workload (``analysis``'s runner) with any classifier that has
a plain reference: the configuration's ``reference``
(``benchmark/reference/<model>.py``) gives the seeded weights, the
published preprocessing, the reference logits, the control and the
operations of a forward, in the place of MobileNetV2's. That module has
``make_weights(config, seed, device)`` (a flat list in the order of the
program's state dict), ``preprocess(x)`` (HWC pixels, on the host, in the
program's order of operations, so that ``input_mismatch`` stays exact),
``forward(x, weights, config, fp8=False)`` and ``flops(config, h, w)``.

Set-up loads the classifier first, so that a program without the
configuration's architecture fails within seconds, before the folder is
written; the rest is ``analysis``'s.

The trace check: after the window the runner queues the batches of one
timed call, twice, back to back behind a spin kernel that gives the host a
head start, and times the forwards with CUDA events, untraced; the host
has to stay ahead of the device throughout, so that no forward waits on
it. The trace's device time of the forwards
(:func:`forward_device_s`) per image forwarded in the traced calls is held
against that reading per image; a trace that dropped operations or
recorded them short reads low.
"""

from __future__ import annotations

import concurrent.futures
import importlib
import time
from pathlib import Path

import numpy as np
import torch

from benchmark.lib import frames
from benchmark.lib.runner import sync
from benchmark.reference import icon as ref_icon
from benchmark.runners import analysis
from benchmark.runners.analysis import ICON, SOURCE, WRITE_THREADS

NOT_FORWARD = ("Memcpy", "Memset", "icon_")  # device operations of the trace that are not the forwards' work
ROUNDS = 2  # times the batches of one call are queued for the trace check
SPIN_CYCLES = 100_000_000  # some 50 ms of spinning: the host's head start
TRACE_AGREES = (0.90, 1.05)  # traced device time per image over the untraced reading, where the trace is sound
REFERENCE_BLOCK = 16  # images per call of the float32 reference forward


def forward_device_s(trace) -> float:
    """Device seconds of the traced operations that are neither copies nor
    sets nor the icon kernel K1: the forwards' work, whatever kernels
    implement it (the harness runs nothing else on the card in this mix)."""
    return sum(e - s for n, s, e in trace.kernels if not any(k in n for k in NOT_FORWARD)) / 1e9


def reference(config: dict):
    """The module that ``config["reference"]`` names."""
    return importlib.import_module(".".join(Path(config["reference"]).with_suffix("").parts))


class Runner(analysis.Runner):
    def __init__(self, cell):
        super().__init__(cell)
        self.ref = reference(cell.config)
        self.queued = None  # (untraced device ms per image, the spin's ms, the host's least lead in ms)

    def make_inputs(self) -> None:
        """The frames (as the harness loads them) and the weights, from the seed."""
        import cv2

        tr = self.cell.traffic
        self.depths = tuple(tr["depths"])
        self.interpolation = getattr(cv2, self.cell.config["interpolation"])
        self.shapes = frames.expand(tr["frames"])
        self.names = [f"frame{i:03d}.png" for i in range(len(self.shapes))]
        self.planar = [frames.photo_like(s, frames.derive(self.cell.seed, "frame", i), self.device).cpu().numpy()
                       for i, s in enumerate(self.shapes)]
        self.frames = [np.ascontiguousarray(np.moveaxis(np.repeat(p, 3, axis=0) if p.shape[0] == 1 else p, 0, -1))
                       for p in self.planar]
        self.mp = sum(h * w for _, h, w in self.shapes) / 1e6
        self.weights = self.ref.make_weights(self.cell.config, frames.derive(self.cell.seed, "weights"), self.device)

    def setup(self) -> None:
        import cv2

        from wicca_tpu_torch.config.constants import MODEL
        from wicca_tpu_torch.harness.processor import ClassifierProcessor
        from wicca_tpu_torch.models import registry
        from wicca_tpu_torch.ops import dwt_cuda

        cfg = self.cell.config
        shape = tuple(cfg["input_size"])
        self.Processor = ClassifierProcessor
        with self.phase("model"):
            clf = registry.load_single_model(cfg["architecture"], shape, device=self.device)
            if clf is None:
                raise RuntimeError(f"the registry could not load {cfg['architecture']}")
        with self.phase("inputs"):
            self.make_inputs()
        with self.phase("weights"):
            module = clf[MODEL].module
            names = list(module.state_dict())
            if len(names) != len(self.weights):
                raise RuntimeError(f"{cfg['architecture']} has {len(names)} state tensors; the reference has"
                                   f" {len(self.weights)}")
            module.load_state_dict(dict(zip(names, self.weights)), strict=True)
            sync(self.device)
            self.capture = analysis.Capture(clf[MODEL])
            clf[MODEL] = self.capture
            self.zoo = {cfg["architecture"]: clf}
            self.flops = self.ref.flops(cfg, *shape)
        with self.phase("png_writes"):
            self.src = self.cell.workdir / "src"
            self.src.mkdir(parents=True)
            level = [cv2.IMWRITE_PNG_COMPRESSION, int(cfg["png_compression"])]

            def write(i):
                p = self.planar[i]
                bgr = p[0] if p.shape[0] == 1 else np.ascontiguousarray(np.moveaxis(p[::-1], 0, -1))
                if not cv2.imwrite(str(self.src / self.names[i]), bgr, level):
                    raise RuntimeError(f"cv2 could not write {self.names[i]}")

            with concurrent.futures.ThreadPoolExecutor(WRITE_THREADS) as pool:
                list(pool.map(write, range(len(self.planar))))
            del self.planar
        with self.phase("warm_call"):
            self._call(self.src, self.cell.workdir / "warm", self.depths)
        self.k1_counter = dwt_cuda.LAUNCHES
        self.k1_start = self.k1_counter["icon"]
        self.capture.rows = 0
        self.outs: list = []

    # -- the reference ---------------------------------------------------

    def _reference_inputs(self) -> dict:
        """{(image, kind, depth): preprocessed input} for every input the
        harness should feed, from the frames as made."""
        import cv2

        size = tuple(self.cell.config["input_size"])
        want = {}
        for i, f in enumerate(self.frames):
            want[(i, SOURCE, 0)] = cv2.resize(f, size, interpolation=self.interpolation)
            planar = torch.from_numpy(np.ascontiguousarray(np.moveaxis(f, -1, 0))).to(self.device)
            for d in self.depths:
                ic = ref_icon.icon(planar, d).cpu().numpy()
                want[(i, ICON, d)] = cv2.resize(np.ascontiguousarray(np.moveaxis(ic, 0, -1)), size,
                                                interpolation=self.interpolation)
        return {k: self.ref.preprocess(torch.from_numpy(v)).numpy() for k, v in want.items()}

    def _reference_logits(self, inputs: dict, fp8: bool = False) -> dict:
        keys = list(inputs)
        out = {}
        for s in range(0, len(keys), REFERENCE_BLOCK):
            part = keys[s : s + REFERENCE_BLOCK]
            x = torch.from_numpy(np.stack([inputs[k] for k in part])).to(self.device)
            out.update(zip(part, self.ref.forward(x, self.weights, self.cell.config, fp8=fp8).cpu().numpy()))
        return out

    # -- the trace check -------------------------------------------------

    def device_ms(self) -> tuple[float, float, float]:
        """Untraced device milliseconds per image of the forwards: the
        batches of the last timed call, ``ROUNDS`` times, queued back to
        back behind a spin kernel, each between two CUDA events (after one
        untimed forward of each batch on this stream, so that none
        allocates). Returns that, the spin's milliseconds, and the host's
        least lead: over the forwards, the least time by which the host had
        queued a forward whole before the device finished it (both clocks
        counted from the spin's start). A forward the host queued only as
        the device ran dry would read a lead near 0 or below."""
        module = self.capture.model.module
        batches = [torch.from_numpy(np.asarray(b)).to(self.device).permute(0, 3, 1, 2)
                   for b, _ in self.capture.calls[-1]] * ROUNDS
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(len(batches) + 2)]
        with torch.inference_mode():
            for x in batches[: len(batches) // ROUNDS]:
                module(x)
            sync(self.device)
            marks[0].record()
            t0 = time.perf_counter()
            torch.cuda._sleep(SPIN_CYCLES)
            queued = []
            for k, x in enumerate(batches):
                marks[k + 1].record()
                module(x)
                queued.append(1e3 * (time.perf_counter() - t0))
            marks[-1].record()
            sync(self.device)
        spin = marks[0].elapsed_time(marks[1])
        ends = [marks[0].elapsed_time(m) for m in marks[2:]]  # device ms from the spin's start to each forward's end
        lead = min(end - q for end, q in zip(ends, queued))
        return (ends[-1] - spin) / sum(len(x) for x in batches), spin, lead

    def trace_check(self, trace) -> tuple[bool, str]:
        """The traced forwards' device time per image against :meth:`device_ms`."""
        if self.device.type != "cuda" or not trace.steps:
            return True, ""
        if self.queued is None:
            self.queued = self.device_ms()
        ms, spin_ms, lead_ms = self.queued
        images = sum(len(b) for call in self.capture.calls[-len(trace.steps):] for b, _ in call)
        traced = 1e3 * forward_device_s(trace) / images
        ratio = traced / ms
        lo, hi = TRACE_AGREES
        note = (f"{traced:.6f} ms of forward device time an image in the trace, {ms:.6f} untraced (queued behind a "
                f"{spin_ms:.3f} ms spin; the host queued each forward at least {lead_ms:.3f} ms before the device "
                f"finished it): ratio "
                f"{ratio:.4f}, sound within [{lo}, {hi}]")
        if lead_ms <= 0:
            return False, f"{note}; the device ran ahead of the host: no reading"
        return lo <= ratio <= hi, note
