"""The port's mesh bring-up (``wicca_tpu_torch.parallel.mesh``): mesh
validation, a mesh on a named backend, the collective health check live
and with a rank that comes late, and ``init_distributed``'s configuration errors, retries and a real
2-rank gloo world whose store starts late (the cases of
``tests/test_mesh_health.py`` and ``tests/test_distributed_2proc.py``).
Worlds of CPU processes through ``run_world``; the ranks never import JAX.
"""

import json
import multiprocessing as mp
import socket

import pytest
import torch
import torch.distributed as dist

from tests import _torch_mesh_ranks as R
from wicca_tpu_torch.parallel import init_distributed, make_mesh, run_world
from wicca_tpu_torch.parallel import mesh as M


@pytest.fixture(scope="module")
def world():
    return run_world(R.mesh_checks, 2, backend="gloo", device_type="cpu", timeout_s=120)


def test_make_mesh_validation(world, monkeypatch):
    assert all(r["too_big"] for r in world)  # 4x4x4 on 2 ranks
    with pytest.raises(ValueError):
        make_mesh(0, 1, 1, device_type="cpu")
    with pytest.raises(RuntimeError, match="no process group"):
        make_mesh(1, 1, 1, device_type="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device_type='cpu'"):
        make_mesh()  # the device rule: None is CUDA
    with pytest.raises(RuntimeError, match="device_type='cpu'"):
        run_world(R.mesh_checks, 2)


def test_make_mesh_takes_the_first_ranks(world):
    assert list(world[0]["coordinate"]) == [0, 0, 0]
    assert world[1]["coordinate"] is None
    assert all(r["already"] for r in world)  # init_distributed in a live world


def test_health_check_passes_on_live_meshes(world):
    assert [r["live"] for r in world] == [[True, True, True]] * 2


def test_health_check_times_out_instead_of_hanging(world):
    """Rank 1 joins 3 s late: rank 0's check returns False after its 1 s
    deadline; rank 1's completes the collective; then both pass."""
    assert world[0]["late"] is False and world[0]["late_s"] < 2.5
    assert world[1]["late"] is True
    assert world[0]["after"] is True and world[1]["after"] is True


def test_make_mesh_with_a_backend_override(world):
    """``backend='gloo'`` makes the mesh dims' own groups on gloo, and a
    collective runs on them."""
    assert [r["override"] for r in world] == [{"backend": "gloo", "own_group": True, "sum": 3.0, "health": True}] * 2


def test_init_distributed_bad_config_returns_false():
    """A configuration error fails at once and reports single-host."""
    assert init_distributed(coordinator="127.0.0.1:x", num_processes=2, process_id=0, retries=3, backoff_s=5.0,
                            backend="gloo") is False
    assert init_distributed(coordinator="127.0.0.1:29500", num_processes=2, process_id=5, retries=3, backoff_s=5.0,
                            backend="gloo") is False
    assert not dist.is_initialized()


def test_init_distributed_retries_transient(monkeypatch):
    calls = {"n": 0}

    def flaky(*a, **kw):
        calls["n"] += 1
        if calls["n"] < 2:
            raise RuntimeError("the store is not up yet")

    monkeypatch.setattr(dist, "init_process_group", flaky)
    assert init_distributed(retries=3, backoff_s=0.0, backend="gloo") is True
    assert calls["n"] == 2
    calls["n"] = -10
    assert init_distributed(retries=2, backoff_s=0.0, backend="gloo") is False  # every attempt failed
    assert calls["n"] == -8
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    assert init_distributed(backend="gloo") is True  # already up: no attempt
    assert calls["n"] == -8
    monkeypatch.setattr(M, "mesh_device_type", lambda d=None: (_ for _ in ()).throw(RuntimeError("no card")))
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    with pytest.raises(RuntimeError, match="no card"):
        init_distributed()  # backend None is NCCL, which needs a card


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_rank_world_whose_store_starts_late(tmp_path):
    """Rank 1 starts first; rank 0, which serves the store, starts 4 s
    later. Rank 1's first attempt to reach the store times out after 1 s
    (its connect loop gives up within about 2 s) and retries; the world
    then forms and an all-reduce counts both ranks."""
    port = _free_port()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=R.late_start, args=(r, port, 4.0 if r == 0 else 0.0, 30.0 if r == 0 else 1.0,
                                                    str(tmp_path / f"r{r}.json"))) for r in (1, 0)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(90)
    alive = [p.is_alive() for p in procs]
    for p in procs:
        if p.is_alive():
            p.kill()
    assert not any(alive) and all(p.exitcode == 0 for p in procs)
    res = {r: json.loads((tmp_path / f"r{r}.json").read_text()) for r in (0, 1)}
    assert res[0] == {"ok": True, "attempts": 1, "sum": 2.0}
    assert res[1]["ok"] and res[1]["sum"] == 2.0 and res[1]["attempts"] >= 2
