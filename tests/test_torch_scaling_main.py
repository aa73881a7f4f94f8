"""``python -m wicca_tpu_torch.parallel.scaling`` on two CPU gloo ranks:
it starts its own world and prints the JSON line of
``python -m wicca_tpu.parallel.scaling`` (``wicca_tpu/parallel/scaling.py``
``__main__``), with the same keys, each row with JAX's row keys; ranks that
share the host's cores carry a ``note``."""

import json
import subprocess
import sys
from pathlib import Path

import jax

from wicca_tpu.parallel.scaling import measure_scaling

ROOT = Path(__file__).resolve().parent.parent


def test_scaling_main_prints_the_jax_line():
    out = subprocess.run([sys.executable, "-m", "wicca_tpu_torch.parallel.scaling", "--device", "cpu", "--ranks",
                          "2", "--size", "64", "64"],
                         cwd=ROOT, capture_output=True, text=True, timeout=240, check=True)
    line = json.loads(out.stdout.strip().splitlines()[-1])
    # the JAX module's line, at a small size (its __main__ runs 4096x4096)
    rows = measure_scaling((64, 64), levels=1, iters=1, device_counts=[1, 2])
    want = {"scaling": rows, "backend": jax.default_backend()}
    assert set(line) == set(want) and line["backend"] == "cpu"
    assert [(r["devices"], r["mesh"]) for r in line["scaling"]] == [(r["devices"], r["mesh"]) for r in rows]
    for got, r in zip(line["scaling"], rows):
        assert set(got) == set(r) | {"note"} and "not meaningful" in got["note"] and got["mp_s"] > 0
    assert line["scaling"][0]["efficiency"] == 1.0
