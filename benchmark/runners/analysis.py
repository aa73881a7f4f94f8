"""The reference's analysis workload: ``ClassifierProcessor.process_classifiers``
over a folder of seeded PNG frames, one classifier (the configuration's
architecture, weights made from the seed), calls back to back.

The harness's settings (``compare``, ``top_classes``, ``interpolation``,
``batch_size``) and the folder's PNG level are the configuration's; the
traffic mix gives the frames and the depths. Set-up writes the folder
into the run's directory (a pool of cv2 PNG writes), loads the classifier
through the registry and hands it the seeded weights by
``load_state_dict``, and warms every shape of the mix: one call over the
folder at its first depth (every frame shape's decode, upload and K1,
the classifier's batch shapes), then one call at each other depth over a
folder of as many links to the mix's smallest frame (K1 and the resizes
at those depths, the same batches). The classifier callable is wrapped,
so every batch the harness feeds it and every logit it returns is kept (a
reference to each array, no copy). Each timed call writes its CSVs into a
folder of its own.

``correct`` compares every kept batch row with the plain reference: its
input (the reference's icon or source, resized by cv2 with the mix's
interpolation and scaled to [-1, 1]) must be equal, element for element,
to one the reference expects (``input_mismatch`` counts rows that match
none, and expected rows never fed); its logits lie within ``logit_gap``
of the reference's float32 forward on that input (the largest |difference|
over the largest |reference logit| of the row); and every CSV row of every
call agrees with the top-k classes of the logits that the harness was
given (``csv_mismatch`` counts rows that disagree, are missing or extra).
"""

from __future__ import annotations

import concurrent.futures
import csv
import hashlib
import os

import numpy as np
import torch

from benchmark.lib import counts, frames
from benchmark.lib import runner as base
from benchmark.lib.runner import Check, sync
from benchmark.reference import icon as ref_icon
from benchmark.reference import mobilenetv2 as ref_net

SOURCE, ICON = "source", "icon"
WRITE_THREADS = 8  # set-up's PNG writes


class Capture:
    """The classifier callable, keeping each batch it is fed and the logits
    it returns (per timed call)."""

    def __init__(self, model):
        self.model = model
        self.calls: list[list] = []
        self.rows = 0

    def __call__(self, batch):
        logits = self.model(batch)
        if self.calls:
            self.calls[-1].append((batch, logits))
        self.rows += len(batch)
        return logits


def _key(row: np.ndarray) -> bytes:
    return hashlib.sha1(np.ascontiguousarray(row, dtype=np.float32).tobytes()).digest()


def _topk(logits: np.ndarray, k: int) -> list[int]:
    """The harness's order: ``np.argsort(row)[::-1][:k]``."""
    return [int(i) for i in np.argsort(logits)[::-1][:k]]


class Runner(base.Runner):
    def make_inputs(self) -> None:
        """The frames (as the harness loads them: HWC RGB, a gray frame's
        plane in all three) and the weights, from the cell's seed."""
        import cv2

        tr = self.cell.traffic
        self.depths = tuple(tr["depths"])
        self.interpolation = getattr(cv2, self.cell.config["interpolation"])
        self.shapes = frames.expand(tr["frames"])
        self.names = [f"frame{i:03d}.png" for i in range(len(self.shapes))]
        self.planar = []
        for i, s in enumerate(self.shapes):
            self.planar.append(frames.photo_like(s, frames.derive(self.cell.seed, "frame", i), self.device).cpu().numpy())
        self.frames = [np.ascontiguousarray(np.moveaxis(np.repeat(p, 3, axis=0) if p.shape[0] == 1 else p, 0, -1))
                       for p in self.planar]
        self.mp = sum(h * w for _, h, w in self.shapes) / 1e6
        self.weights = ref_net.make_weights(self.cell.config, frames.derive(self.cell.seed, "weights"), self.device)

    def setup(self) -> None:
        import cv2

        from wicca_tpu_torch.config.constants import MODEL
        from wicca_tpu_torch.harness.processor import ClassifierProcessor
        from wicca_tpu_torch.models import registry

        cfg = self.cell.config
        self.Processor = ClassifierProcessor
        with self.phase("inputs"):
            self.make_inputs()
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
        with self.phase("model"):
            shape = tuple(cfg["input_size"])
            clf = registry.load_single_model(cfg["architecture"], shape, device=self.device)
            if clf is None:
                raise RuntimeError(f"the registry could not load {cfg['architecture']}")
            module = clf[MODEL].module
            names = list(module.state_dict())
            if len(names) != len(self.weights):
                raise RuntimeError(f"{cfg['architecture']} has {len(names)} state tensors; the reference has"
                                   f" {len(self.weights)}")
            module.load_state_dict(dict(zip(names, self.weights)), strict=True)
            sync(self.device)
            self.capture = Capture(clf[MODEL])
            clf[MODEL] = self.capture
            self.zoo = {cfg["architecture"]: clf}
            self.flops = counts.mobilenetv2_flops(cfg, *shape)
        with self.phase("warm_call"):
            self._call(self.src, self.cell.workdir / "warm", self.depths[:1])
        if len(self.depths) > 1:
            with self.phase("warm_depths"):
                smallest = min(range(len(self.shapes)), key=lambda i: self.shapes[i][1] * self.shapes[i][2])
                links = self.cell.workdir / "warm_src"
                links.mkdir()
                for name in self.names:
                    os.link(self.src / self.names[smallest], links / name)
                self._call(links, self.cell.workdir / "warm_depths", self.depths[1:])
        from wicca_tpu_torch.ops import dwt_cuda

        self.k1_counter = dwt_cuda.LAUNCHES
        self.k1_start = self.k1_counter["icon"]
        self.capture.rows = 0
        self.outs: list = []

    def _call(self, src, out, depths) -> None:
        cfg = self.cell.config
        proc = self.Processor(src, transform_depth=depths if len(depths) > 1 else depths[0],
                              interpolation=self.interpolation, top_classes=int(cfg["top_classes"]),
                              results_folder=out, log_info=False, batch_size=int(cfg["batch_size"]),
                              compare=cfg["compare"], device=self.device)
        proc.process_classifiers(self.zoo)

    def step(self, i: int) -> float:
        out = self.cell.workdir / "results" / str(i)
        self.outs.append(out)
        self.capture.calls.append([])
        self._call(self.src, out, self.depths)
        return self.mp * len(self.depths)

    def collect(self) -> None:
        """Stage seconds of every timed call's ``run-metrics.json``, summed."""
        import json

        for out in self.outs:
            for d in self.depths:
                stages = json.loads((out / f"depth-{d}" / "run-metrics.json").read_text())["stage_seconds"]
                for stage, s in stages.items():
                    self.counters[f"stage.{stage}"] += s
        self.counters["calls"] = len(self.outs)
        self.counters["k1_launches"] = self.k1_counter["icon"] - self.k1_start
        self.counters["source_mp"] = self.mp * len(self.depths) * len(self.outs)
        self.counters["forwards"] = self.capture.rows
        self.counters["forward_flops"] = self.capture.rows * self.flops
        self.counters["icon_bytes"] = len(self.outs) * sum(
            counts.icon_bytes(3, h, w, d) for _, h, w in self.shapes for d in self.depths)

    # -- the reference ---------------------------------------------------

    def _reference_inputs(self) -> dict:
        """{(image, kind, depth): preprocessed 224 x 224 input} for every
        input the harness should feed, from the frames as made."""
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
        return {k: v.astype(np.float32) / np.float32(127.5) - np.float32(1.0) for k, v in want.items()}

    def _reference_logits(self, inputs: dict, fp8: bool = False) -> dict:
        keys = list(inputs)
        out = {}
        for s in range(0, len(keys), 32):
            part = keys[s : s + 32]
            x = torch.from_numpy(np.stack([inputs[k] for k in part])).to(self.device)
            logits = ref_net.forward(x, self.weights, self.cell.config, fp8=fp8).cpu().numpy()
            out.update(zip(part, logits))
        return out

    def check(self):
        del self.zoo  # the program's model state, before the reference runs
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        want = self._reference_inputs()
        by_key: dict = {}
        for k, v in want.items():
            by_key.setdefault(_key(v), []).append(k)
        ref = self._reference_logits(want)
        top = int(self.cell.config["top_classes"])
        unmatched, gap, seen, wrong = 0, 0.0, set(), set()
        program: list[dict] = []  # per call: {(image, kind, depth): [logit rows]}
        for call in self.capture.calls:
            got: dict = {}
            for batch, logits in call:
                for row, lg in zip(batch, np.asarray(logits)):
                    keys = by_key.get(_key(row))
                    if keys is None:
                        unmatched += 1
                        continue
                    seen.update(keys)
                    r = ref[keys[0]]
                    g = float(np.abs(lg.astype(np.float64) - r).max() / np.abs(r).max())
                    gap = max(gap, g)
                    for k in keys:
                        got.setdefault(k, []).append(lg)
            program.append(got)
        missing = len(set(want) - seen) if self.capture.calls else len(want)
        csv_bad = 0
        for n, (out, got) in enumerate(zip(self.outs, program)):
            for d in self.depths:
                rows = self._read_csv(out, d)
                for i, name in enumerate(self.names):
                    row = rows.pop(name, None)
                    srcs, icons = got.get((i, SOURCE, 0), []), got.get((i, ICON, d), [])
                    ok = row is not None and any(
                        row == (len(set(_topk(s, top)) & set(_topk(c, top))), 100.0 * (_topk(s, 1) == _topk(c, 1)))
                        for s in srcs for c in icons)
                    if not ok:
                        csv_bad += 1
                        wrong.add((n, d, i))
                csv_bad += len(rows)
        checks = [Check("input_mismatch", unmatched + missing, self.limit("input_mismatch")),
                  Check("logit_gap", gap, self.limit("logit_gap")),
                  Check("csv_mismatch", csv_bad, self.limit("csv_mismatch"))]
        failed = len(wrong) + unmatched + missing + (gap > self.limit("logit_gap"))
        return checks, failed

    def _read_csv(self, out, depth) -> dict:
        arch = self.cell.config["architecture"]
        path = out / f"depth-{depth}" / f"{arch}-depth-{depth}.csv"
        if not path.is_file():
            return {}
        with open(path, newline="") as f:
            return {r["file"]: (int(float(r["similar classes (count)"])), float(r["similar best class"]))
                    for r in csv.DictReader(f)}

    def control(self) -> list[Check]:
        """The reference forward with every layer's input and weight in
        float8 put in the program's place, on the reference's inputs."""
        self.make_inputs()
        want = self._reference_inputs()
        ref, low = self._reference_logits(want), self._reference_logits(want, fp8=True)
        gap = max(float(np.abs(low[k].astype(np.float64) - ref[k]).max() / np.abs(ref[k]).max()) for k in want)
        return [Check("logit_gap", gap, self.limit("logit_gap"))]
