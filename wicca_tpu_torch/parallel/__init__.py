"""The mesh on ``torch.distributed`` (counterpart of ``wicca_tpu.parallel``):
a ``DeviceMesh`` over ``(data, ty, tx)``, tiled transforms and the tiled
codec with halo exchange, the data-parallel batched codec, tensor, pipeline
and expert parallelism, and :func:`~wicca_tpu_torch.parallel.launch.run_world`
to start a world of local processes. Every rank calls each function
together (SPMD); sharded results are DTensors, and :func:`gather` makes
their full tensors.
"""

from wicca_tpu_torch.comm import gather
from wicca_tpu_torch.parallel.codec import tiled_decode, tiled_encode
from wicca_tpu_torch.parallel.launch import run_world
from wicca_tpu_torch.parallel.mesh import (
    batch_placements,
    data_mesh,
    init_distributed,
    make_mesh,
    mesh_health_check,
    tile_placements,
)
from wicca_tpu_torch.parallel.model_parallel import model_mesh, moe_apply, pp_apply, tp_mlp_apply
from wicca_tpu_torch.parallel.tiled import tiled_dwt2, tiled_icon, tiled_idwt2, tiled_stats

__all__ = [
    "batch_placements",
    "data_mesh",
    "gather",
    "init_distributed",
    "make_mesh",
    "mesh_health_check",
    "model_mesh",
    "moe_apply",
    "pp_apply",
    "run_world",
    "tile_placements",
    "tiled_decode",
    "tiled_dwt2",
    "tiled_encode",
    "tiled_icon",
    "tiled_idwt2",
    "tiled_stats",
    "tp_mlp_apply",
]
