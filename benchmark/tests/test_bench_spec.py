"""BENCHMARK.json against the format it keeps to, and every name in it
against the file that the harness finds by that name."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
DOC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(DOC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert DOC["command"] == ["python3", "benchmark/run.py"]
    assert DOC["paths"] == ["benchmark"]
    assert isinstance(DOC["run_seconds"], int) and 1 <= DOC["run_seconds"] <= 51
    assert len(json.dumps(DOC)) <= 64 * 1024


@pytest.mark.parametrize("config", DOC["configs"], ids=lambda c: c["name"])
def test_config(config):
    assert set(config) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(config["name"]) and config["file"].startswith("benchmark/")
    body = json.loads((ROOT / config["file"]).read_text())
    assert body["name"] == config["name"] and body["reduced"] == config["reduced"] == []
    assert (ROOT / body["reference"]).is_file()
    assert any(w["config"] == config["name"] for w in DOC["workloads"])


@pytest.mark.parametrize("cell", DOC["workloads"], ids=lambda w: w["name"])
def test_cell(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"]) and cell["chips"] == 1
    assert 1 <= len(cell["why"]) <= 200 and "\n" not in cell["why"]
    traffic = json.loads((ROOT / "benchmark" / "traffic" / f"{cell['traffic']}.json").read_text())
    assert (ROOT / "benchmark" / "runners" / f"{traffic['runner']}.py").is_file()
    e2e = [m for m in DOC["end_to_end"] if "workloads" not in m or cell["name"] in m["workloads"]]
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert any(cell["name"] in m.get("workloads", []) for m in DOC["per_layer"])


@pytest.mark.parametrize("metric", DOC["end_to_end"] + DOC["per_layer"], ids=lambda m: m["name"])
def test_metric(metric):
    e2e = metric in DOC["end_to_end"]
    keys = {"name", "unit", "better", "source"} | ({"bound"} if e2e else {"layer", "moves"})
    assert set(metric) - {"workloads"} == keys
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"]) and metric["better"] in ("lower", "higher")
    assert (ROOT / "benchmark" / "metrics" / f"{metric['name']}.py").is_file()
    cells = {w["name"] for w in DOC["workloads"]}
    assert set(metric.get("workloads", [])) <= cells
    if e2e:
        assert metric["source"] in ("host_clock", "device_trace") and 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        moved = next(m for m in DOC["end_to_end"] if m["name"] == metric["moves"])
        assert set(metric["workloads"]) <= set(moved.get("workloads", cells))
    if metric["name"].endswith("_roofline") or "mfu" in metric["name"]:
        assert metric["unit"] == "%"
