"""The device mesh on ``torch.distributed`` (counterpart of
``wicca_tpu/parallel/mesh.py``).

JAX's ``shard_map`` is one controller driving many devices; the port runs
SPMD, one process per rank, each calling the same function. The mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with dims

* ``data`` — a batch of images split over ranks (DP);
* ``ty``/``tx`` — spatial tiles of one large image (the 2-D analog of
  sequence parallelism); halos cross ranks point to point
  (:mod:`wicca_tpu_torch.parallel.halo`).

A global array sharded as JAX's ``NamedSharding(mesh, P(..., 'ty', 'tx'))``
is a ``DTensor`` with :func:`tile_placements` (``Replicate`` on ``data``,
``Shard`` of the last two dims on ``ty`` and ``tx``); its ``full_tensor()``
is the JAX array (on a gloo group with CUDA tensors, gather with
:func:`wicca_tpu_torch.parallel.gather`).

Device rule: ``device_type=None`` means CUDA, and with no card it raises
unless the caller asks for ``'cpu'``. The world's backend is NCCL for CUDA
and gloo for the CPU; several ranks that share one card run gloo with CUDA
tensors, and the port's own exchanges then stage them through pinned host
memory (:mod:`wicca_tpu_torch.comm`).
"""

from __future__ import annotations

import datetime
import logging
import time

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

from wicca_tpu_torch.comm import all_reduce_start

DATA_AXIS = "data"
TILE_ROW_AXIS = "ty"
TILE_COL_AXIS = "tx"


def mesh_device_type(device_type=None) -> str:
    """``device_type`` under the device rule: None is CUDA, which needs a card."""
    dt = "cuda" if device_type is None else str(device_type)
    if dt == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device_type='cpu' (and backend='gloo') to run the "
                           "mesh on the CPU")
    return dt


def default_backend(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def _config_error(coordinator, num_processes, process_id) -> str | None:
    """What is wrong with a TCP rendezvous configuration, or None."""
    host, _, port = str(coordinator).rpartition(":")
    if not host or not port.isdigit() or not 0 < int(port) < 65536:
        return f"coordinator must be host:port, got {coordinator!r}"
    if not isinstance(num_processes, int) or not isinstance(process_id, int) or not 0 <= process_id < num_processes:
        return f"process_id {process_id!r} is not a rank of {num_processes!r} processes"
    return None


def _join_tcp(coordinator: str, n: int, rank: int, backend: str, timeout) -> None:
    """Connect to the coordinator's TCP store (rank 0 serves it), then make
    the process group on it. A late coordinator fails the store's connect
    cleanly, before any key is written, so the next attempt starts fresh."""
    host, _, port = coordinator.rpartition(":")
    kw = {} if timeout is None else {"timeout": timeout}
    store = dist.TCPStore(host, int(port), n, is_master=rank == 0, wait_for_workers=False, **kw)
    dist.init_process_group(backend, store=store, rank=rank, world_size=n, **kw)


def init_distributed(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    retries: int = 3,
    backoff_s: float = 5.0,
    init_timeout_s: float | None = None,
    backend: str | None = None,
) -> bool:
    """Join the process group (``dist.init_process_group``) with linear
    backoff between attempts.

    No arguments: ``env://`` (what ``torchrun`` sets); else the TCP store of
    ``coordinator`` (``host:port``, rank 0 serves it) with ``num_processes``
    ranks, this one ``process_id``. ``backend`` None is NCCL, which needs a
    card (pass ``'gloo'`` for the CPU). Each attempt waits at most
    ``init_timeout_s`` (torch's default otherwise). Returns True once the
    group is up (or already was); False at once on a configuration error
    (``ValueError``), or when every attempt failed, so the process can go on
    alone. A coordinator that is not ``host:port``, or a ``process_id``
    outside ``range(num_processes)``, is a configuration error.
    """
    if dist.is_initialized():
        return True
    backend = backend or default_backend(mesh_device_type())
    timeout = None if init_timeout_s is None else datetime.timedelta(seconds=max(1.0, float(init_timeout_s)))
    tcp = coordinator is not None or num_processes is not None
    if tcp:
        bad = _config_error(coordinator, num_processes, process_id)
        if bad:  # retrying will not help
            logging.info(f"torch.distributed not initialized: {bad}")
            return False
    last: Exception | None = None
    retries = max(1, retries)
    for attempt in range(retries):
        try:
            if tcp:
                _join_tcp(coordinator, num_processes, process_id, backend, timeout)
            else:
                dist.init_process_group(backend, init_method="env://", **({"timeout": timeout} if timeout else {}))
            return True
        except ValueError as e:  # a configuration error: retrying will not help
            logging.info(f"torch.distributed not initialized: {e}")
            return False
        except (RuntimeError, TimeoutError) as e:  # the store not up yet, a peer late
            if dist.is_initialized():
                return True
            last = e
        if attempt + 1 < retries:
            wait = backoff_s * (attempt + 1)
            logging.warning(f"joining the process group failed (attempt {attempt + 1}/{retries}): {last}; "
                            f"retrying in {wait:.1f}s")
            time.sleep(wait)
    logging.warning(f"torch.distributed unavailable after {retries} attempts: {last}")
    return False


def _world_size() -> int:
    if not dist.is_initialized():
        raise RuntimeError("no process group: start the ranks with torchrun (then init_distributed()), "
                           "init_distributed(...), or wicca_tpu_torch.parallel.launch.run_world")
    return dist.get_world_size()


def _device_mesh(device_type: str, shape: tuple, names: tuple, backend) -> DeviceMesh:
    ranks = torch.arange(int(torch.tensor(shape).prod())).reshape(shape)
    if backend is None:
        return DeviceMesh(device_type, ranks, mesh_dim_names=names)
    return DeviceMesh(device_type, ranks, mesh_dim_names=names, backend_override=((backend, None),) * len(shape))


def make_mesh(data: int = 1, ty: int = 1, tx: int = 1, device_type=None, backend: str | None = None) -> DeviceMesh:
    """Mesh over ``(data, ty, tx)`` on the first ``data * ty * tx`` ranks of
    the world (as JAX's takes the first devices). Every rank of the world
    calls it (the mesh's groups are made collectively); a rank outside the
    mesh gets ``get_coordinate() is None``. ``backend`` None gives the mesh
    dims' groups the world's backend; a name (``'gloo'``, ``'nccl'``) makes
    them on that backend."""
    for name, v in (("data", data), ("ty", ty), ("tx", tx)):
        if int(v) < 1:
            raise ValueError(f"mesh dim {name} must be >= 1, got {v}")
    dt = mesh_device_type(device_type)
    n = _world_size()
    want = data * ty * tx
    if want > n:
        raise ValueError(f"mesh {data}x{ty}x{tx} needs {want} ranks, have {n}")
    return _device_mesh(dt, (data, ty, tx), (DATA_AXIS, TILE_ROW_AXIS, TILE_COL_AXIS), backend)


def data_mesh(device_type=None) -> DeviceMesh:
    """1-D mesh over every rank of the world, for batch (DP) sharding."""
    return _device_mesh(mesh_device_type(device_type), (_world_size(),), (DATA_AXIS,), None)


def axis_size(mesh: DeviceMesh, name: str) -> int:
    """Size of mesh dim ``name`` (1 when the mesh has no such dim)."""
    names = mesh.mesh_dim_names or ()
    return mesh.shape[names.index(name)] if name in names else 1


def axis_index(mesh: DeviceMesh, name: str) -> int:
    """This rank's coordinate on mesh dim ``name`` (0 when the mesh has none)."""
    return mesh.get_local_rank(name) if name in (mesh.mesh_dim_names or ()) else 0


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank's tensors of ``mesh`` lie on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def tile_placements(mesh: DeviceMesh, ndim: int) -> list:
    """Placements of planar images ``(..., H, W)``: H over ``ty``, W over
    ``tx``, replicated over the other dims (JAX's ``tile_sharding``)."""
    by_name = {TILE_ROW_AXIS: Shard(ndim - 2), TILE_COL_AXIS: Shard(ndim - 1)}
    return [by_name.get(name, Replicate()) for name in mesh.mesh_dim_names]


def batch_placements(mesh: DeviceMesh) -> list:
    """Placements of batched data ``(N, ...)``: N over ``data`` (JAX's
    ``batch_sharding``)."""
    return [Shard(0) if name == DATA_AXIS else Replicate() for name in mesh.mesh_dim_names]


def replicated(mesh: DeviceMesh) -> list:
    return [Replicate()] * mesh.ndim


def mesh_health_check(mesh: DeviceMesh, timeout_s: float = 60.0) -> bool:
    """Pre-flight collective check: an all-reduce of ones over every mesh
    dim must count the mesh's ranks. Catches a dead link or a wedged rank
    before a long run commits to the mesh.

    Each all-reduce runs with ``async_op=True`` and is polled against one
    deadline, so a hang returns False after ``timeout_s`` instead of
    blocking. The abandoned collective stays queued: on gloo it completes
    if the missing rank joins later, and fails at the group's timeout
    otherwise; on NCCL the watchdog aborts the process at the group's
    timeout (10 minutes by default) unless the rank joins.
    """
    count = torch.ones(1, dtype=torch.int32, device=mesh_device(mesh))
    deadline = time.monotonic() + timeout_s
    try:
        for name in mesh.mesh_dim_names:
            work, finish = all_reduce_start(count, mesh.get_group(name))
            while not work.is_completed():
                if time.monotonic() > deadline:
                    return False
                time.sleep(0.001)
            work.wait()
            finish()
        return int(count.item()) == mesh.size()
    except RuntimeError as e:  # a failed collective: the mesh is not healthy
        logging.warning(f"mesh health check failed: {e}")
        return False

