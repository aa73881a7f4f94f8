"""A cell as ``BENCHMARK.json`` names it: its configuration, its traffic
mix, the runner that mix names and the metrics it reports, all found by
name; and the record of one run that the metric readers read."""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list  # BENCHMARK.json entries this cell reports with --trace 0
    per_layer: list  # ... and with --trace 1
    seed: int = 0
    seconds: float = 10.0
    trace: bool = False
    device: object = None
    workdir: Path | None = None  # the run's own directory under TMPDIR


def _reports(metric: dict, cell: str, e2e_names: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") in e2e_names if "moves" in metric else True


def load(workload: str, root: Path = ROOT) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json``."""
    doc = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in doc["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json; have {sorted(cells)}")
    w = cells[workload]
    entry = {c["name"]: c for c in doc["configs"]}[w["config"]]
    config = json.loads((root / entry["file"]).read_text())
    traffic = json.loads((root / "benchmark" / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in doc["end_to_end"] if _reports(m, workload, set())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in doc["per_layer"] if _reports(m, workload, names)]
    return Cell(name=workload, chips=w["chips"], config=config, traffic=traffic, end_to_end=e2e, per_layer=per_layer)


def runner_class(cell: Cell):
    """``benchmark/runners/<traffic["runner"]>.py``'s ``Runner``."""
    return importlib.import_module(f"benchmark.runners.{cell.traffic['runner']}").Runner


def metric_reader(name: str, root: Path = ROOT):
    """``benchmark/metrics/<name>.py``'s ``read(run)``."""
    path = root / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


@dataclass
class Run:
    """What one run leaves for the metric readers."""

    cell: Cell
    setup_s: float
    steps: list  # (start, end, units) per timed step, perf_counter seconds
    spans: dict  # name -> [total seconds, count] (host clock, the whole window)
    counters: dict  # name -> number (the whole window)
    samples: dict  # name -> [one reading per step] (the whole window)
    device_name: str = ""
    trace: object = None  # lib.trace.Trace of the traced slice, with --trace 1

    @property
    def window_s(self) -> float:
        return self.steps[-1][1] - self.steps[0][0]

    @property
    def steps_s(self) -> float:
        """The steps' own seconds, summed (the window less the gaps between steps)."""
        return sum(t1 - t0 for t0, t1, _ in self.steps)

    @property
    def units(self) -> float:
        return sum(u for _, _, u in self.steps)

    def span_total(self, name: str) -> float | None:
        s = self.spans.get(name)
        return s[0] if s and s[1] else None
