"""Cells of BENCHMARK.json cut to a size the CPU runs in seconds, for the
tests only: the harness's look for a card is skipped and the program runs
its CPU path (the kernels' plain twins)."""

from __future__ import annotations

import io
import json
import time

import torch

from benchmark.lib.cell import ROOT, load

TINY = {
    "haar-d5.resident": {"frames": [{"shape": [3, 256, 192], "count": 3}], "sample": 2, "trace_seconds": 0.3},
    "haar-d5.wct": {"frames": [{"shape": [3, 128, 96], "count": 2}], "sample": 2},
    "mobilenetv2.depths2-6": {"frames": [[3, 200, 264], [1, 96, 131]], "depths": [2, 3]},
    "mobilenetv2.2k-depth5": {"frames": [{"shape": [3, 96, 128], "count": 3}]},
}
CONFIG = {"mobilenetv2.2k-depth5": {"batch_size": 2}}  # the configuration's settings cut with it
# mixes that no cell of BENCHMARK.json runs yet, with the cell whose configuration and metrics they take
UNLISTED = {"mobilenetv2.depths2-6": ("mobilenetv2.2k-depth5", "depths2-6")}


def tiny_cell(workload: str, tmp_path, seed: int = 2**31 + 11, seconds: float = 0.2, trace: bool = False, **traffic):
    base, mix = UNLISTED.get(workload, (workload, None))
    cell = load(base)
    if mix:
        cell.name = workload
        cell.traffic = json.loads((ROOT / "benchmark" / "traffic" / f"{mix}.json").read_text())
    cell.traffic = {**cell.traffic, **TINY[workload], **traffic}
    cell.config = {**cell.config, **CONFIG.get(workload, {})}
    if "frame" in cell.config:
        cell.config["frame"] = cell.traffic["frames"][0]["shape"]
    cell.seed, cell.seconds, cell.trace, cell.device = seed, seconds, trace, "cpu"
    cell.workdir = tmp_path
    return cell


def run_cell(cell) -> tuple[int, dict | None, str]:
    """``execute`` on ``cell``: exit code, the result line, standard error."""
    from benchmark.run import execute

    torch.set_num_threads(2)
    out, err = io.StringIO(), io.StringIO()
    rc = execute(cell, time.perf_counter(), out=out, err=err)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()
