"""Run a function on every rank of a world of local processes: the port's
stand-in for JAX's ``--xla_force_host_platform_device_count`` (used by the
tests, ``chip_smoke.py`` and :func:`wicca_tpu_torch.entry.dryrun_multichip`).

    results = run_world(fn, 4, arg, backend="gloo", device_type="cpu")

Each rank is a spawned process that joins the world through a ``FileStore``
in a temporary directory (no port to race for), runs ``fn(*args)`` and
hands its return value back (``torch.save``; the caller reads what its own
ranks wrote). ``fn`` must be importable by name (a module-level function).
A rank that raises, or a world that outlives ``timeout_s``, ends every rank
and raises in the caller with the rank's traceback.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import tempfile
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

from wicca_tpu_torch.parallel.mesh import default_backend, mesh_device_type


def _rank_main(fn, rank: int, world_size: int, backend: str, device_type: str, tmp: str, args,
               timeout_s: float) -> None:
    out = Path(tmp)
    try:
        if device_type == "cpu":
            torch.set_num_threads(1)  # the ranks share the host's cores
        else:
            torch.cuda.set_device(rank % torch.cuda.device_count())
        store = dist.FileStore(str(out / "store"), world_size)
        dist.init_process_group(backend, store=store, rank=rank, world_size=world_size,
                                timeout=datetime.timedelta(seconds=timeout_s))
        try:
            result = fn(*args)
        finally:
            dist.destroy_process_group()
        torch.save(result, out / f"rank{rank}.pt")
    except BaseException:
        (out / f"rank{rank}.err").write_text(traceback.format_exc())
        raise SystemExit(1) from None


def run_world(fn, world_size: int, *args, backend: str | None = None, device_type: str | None = None,
              timeout_s: float = 120.0) -> list:
    """``fn(*args)`` on each of ``world_size`` ranks; their return values in
    rank order. ``device_type`` None is CUDA (each rank on card ``rank %
    device_count``), which needs a card; ``backend`` None is NCCL for CUDA
    and gloo for the CPU (ranks that share a card pass ``backend='gloo'``).
    A CPU rank runs torch on one thread."""
    device_type = mesh_device_type(device_type)
    backend = backend or default_backend(device_type)
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="wicca_world_") as tmp:
        procs = [ctx.Process(target=_rank_main, args=(fn, r, world_size, backend, device_type, tmp, args, timeout_s))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        failed = None
        try:
            while any(p.is_alive() for p in procs):
                failed = next((r for r, p in enumerate(procs) if p.exitcode not in (None, 0)), None)
                if failed is not None or time.monotonic() > deadline:
                    break
                time.sleep(0.02)
            else:
                failed = next((r for r, p in enumerate(procs) if p.exitcode != 0), None)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join(10)
        if failed is not None:
            # the first traceback written is the cause; later ones are often its echo
            errs = sorted(Path(tmp).glob("rank*.err"), key=lambda f: f.stat().st_mtime)
            why = errs[0].read_text() if errs else f"exit code {procs[failed].exitcode}"
            first = errs[0].stem if errs else f"rank{failed}"
            raise RuntimeError(f"{first} of a world of {world_size} failed:\n{why}")
        if any(p.exitcode != 0 for p in procs):
            raise TimeoutError(f"the world of {world_size} ranks ran past {timeout_s} s")
        return [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False) for r in range(world_size)]
