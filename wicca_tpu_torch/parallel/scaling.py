"""Scaling of the tiled transforms over mesh sizes (counterpart of
``wicca_tpu/parallel/scaling.py``): the tiled DWT + IDWT roundtrip on the
first ``n`` ranks of the world for several ``n``, its megapixels/s and its
efficiency against the smallest ``n``.

Runs inside a world: every rank calls :func:`measure_scaling` (each
sub-mesh's groups are made collectively), the ranks of the sub-mesh time
the roundtrip and every rank returns the same rows. Ranks that share one
card (or CPU processes that share the host's cores) say nothing of
scaling; the rows then carry a ``note`` saying so.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from wicca_tpu_torch.comm import all_reduce_
from wicca_tpu_torch.parallel.mesh import make_mesh, mesh_device, mesh_device_type
from wicca_tpu_torch.parallel.tiled import tiled_dwt2, tiled_idwt2


def _mesh_shapes(n: int) -> list[tuple[int, int]]:
    """(ty, tx) factorizations of ``n`` with ty a power of two."""
    shapes, ty = [], 1
    while ty <= n:
        if n % ty == 0:
            shapes.append((ty, n // ty))
        ty *= 2
    return shapes


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _meaningless(device_type: str, n: int) -> str | None:
    """Why efficiency means nothing for ``n`` ranks here, or None."""
    if device_type == "cpu":
        return f"{n} CPU processes share the host's cores: efficiency is not meaningful"
    if n > torch.cuda.device_count():
        return f"{n} ranks share {torch.cuda.device_count()} card(s): efficiency is not meaningful"
    return None


def measure_scaling(image_hw: tuple[int, int] = (4096, 4096), levels: int = 3, wavelet: str = "bior4.4",
                    iters: int = 3, device_counts=None, device_type=None) -> list[dict]:
    """Time the tiled DWT + IDWT roundtrip of a seeded ``1 x H x W`` uint8
    image (best of ``iters`` after one warm-up) on the first ``n`` ranks for
    each ``n`` of ``device_counts`` (default: 1, 2 and the world size).
    Returns ``{devices, mesh, mp_s, efficiency[, note]}`` rows; efficiency is
    relative to the first count (ideal 1)."""
    device_type = mesh_device_type(device_type)
    world = dist.get_world_size()
    counts = sorted({1, 2, world}) if device_counts is None else list(device_counts)
    h, w = image_hw
    img = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (1, h, w), np.uint8))
    rows, base = [], None
    for n in counts:
        if n > world:
            continue
        shapes = _mesh_shapes(n)
        ty, tx = shapes[len(shapes) // 2]  # the squarest factorization
        mesh = make_mesh(ty=ty, tx=tx, device_type=device_type)
        dev = mesh_device(mesh)
        dt = torch.zeros(1, dtype=torch.float64, device=dev)
        if mesh.get_coordinate() is not None:
            x = img.to(dev)
            times = []
            for _ in range(iters + 1):  # the first is the warm-up
                _sync(dev)
                t0 = time.perf_counter()
                tiled_idwt2(tiled_dwt2(x, levels, wavelet, mesh=mesh), mesh=mesh)
                _sync(dev)
                times.append(time.perf_counter() - t0)
            dt[0] = min(times[1:])
        # every rank takes the sub-mesh's time (the slowest of its ranks)
        all_reduce_(dt, dist.group.WORLD, dist.ReduceOp.MAX)
        mp_s = h * w / 1e6 / float(dt[0])
        if base is None:
            base = (mp_s, n)
        row = {"devices": n, "mesh": f"{ty}x{tx}", "mp_s": mp_s, "efficiency": (mp_s / base[0]) / (n / base[1])}
        note = _meaningless(device_type, n)
        if note:
            row["note"] = note
        rows.append(row)
    return rows


def _rank_rows(image_hw, device_type: str) -> list[dict]:
    return measure_scaling(image_hw, device_type=device_type)


def main(argv=None) -> int:
    """``python -m wicca_tpu_torch.parallel.scaling``: one world of local
    ranks (:func:`~wicca_tpu_torch.parallel.launch.run_world`) runs
    :func:`measure_scaling`; prints ``{"scaling": rows, "backend": ...}``.
    On the card the world has one NCCL rank per card, or, with more ranks
    than cards, gloo ranks that share them (their rows carry a ``note``)."""
    import argparse
    import json

    from wicca_tpu_torch.parallel.launch import run_world

    ap = argparse.ArgumentParser(prog="python -m wicca_tpu_torch.parallel.scaling", description=main.__doc__)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--ranks", type=int, default=None,
                    help="world size (default: the number of cards, at least 2; 2 on the CPU)")
    ap.add_argument("--size", type=int, nargs=2, default=(4096, 4096), metavar=("H", "W"))
    args = ap.parse_args(argv)
    device_type = mesh_device_type(args.device)
    cards = torch.cuda.device_count() if device_type == "cuda" else 0
    ranks = args.ranks or max(2, cards)
    backend = "nccl" if device_type == "cuda" and ranks <= cards else "gloo"
    rows = run_world(_rank_rows, ranks, tuple(args.size), device_type, backend=backend, device_type=device_type,
                     timeout_s=600.0)[0]
    print(json.dumps({"scaling": rows, "backend": device_type}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
