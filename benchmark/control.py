"""The control of a cell: its compared numbers with the plain reference,
computed in the next precision below the configuration's, put in the
program's place (the Haar reference in bfloat16 for ``haar-d5``'s float
arithmetic; the MobileNetV2 reference with every layer's input and weight
in float8 e4m3 for ``mobilenetv2``'s bfloat16). A sound benchmark reads
``correct`` false for every seed. The benchmark's own runs never run it.

    python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...]

One JSON line per seed: the seed, ``correct`` and each number beside its
limit. Needs a CUDA card, as the cell does.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def read(cell) -> dict:
    """The control's checks on ``cell`` (its seed and device set)."""
    from benchmark.lib.cell import runner_class

    checks = runner_class(cell)(cell).control()
    return {"seed": cell.seed, "correct": all(c.ok for c in checks),
            "checks": {c.name: {"value": c.value, "limit": c.limit} for c in checks}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark.lib.cell import load

    if not torch.cuda.is_available():
        print("the control runs on a CUDA card; none here", file=sys.stderr)
        return 2
    for seed in args.seeds:
        cell = load(args.workload, ROOT)
        cell.seed, cell.device = seed, "cuda:0"
        cell.workdir = Path(tempfile.mkdtemp(prefix="wicca-control-", dir=os.environ.get("TMPDIR")))
        print(json.dumps(read(cell)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
