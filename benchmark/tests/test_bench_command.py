"""The command as a checkout runs it: without a CUDA card, or without the
program beside the benchmark, it fails and prints no result."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
ARGS = ["--workload", "haar-d5.resident", "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"]


def run(cwd: Path, visible: str = ""):
    """The command in ``cwd`` with only the cards ``visible`` lists (none by default)."""
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": visible}
    return subprocess.run([sys.executable, "benchmark/run.py", *ARGS], cwd=cwd, capture_output=True, text=True,
                          timeout=600, env=env)


def no_result(proc) -> bool:
    for line in proc.stdout.splitlines():
        try:
            if isinstance(json.loads(line), dict):
                return False
        except ValueError:
            pass
    return True


def test_fails_without_a_card():
    proc = run(ROOT)
    assert proc.returncode != 0 and no_result(proc), proc.stderr[-2000:]
    assert "CUDA card" in proc.stderr


def test_fails_without_the_program(tmp_path):
    (tmp_path / "BENCHMARK.json").write_text((ROOT / "BENCHMARK.json").read_text())
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    proc = run(tmp_path)
    assert proc.returncode != 0 and no_result(proc)


@pytest.mark.cuda
def test_a_short_run_on_the_card(card):
    proc = run(ROOT, "0")
    assert proc.returncode == 0, proc.stderr[-2000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
