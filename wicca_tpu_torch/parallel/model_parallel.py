"""Tensor, pipeline and expert parallelism over a 1-D ``model`` mesh
(counterpart of ``wicca_tpu/parallel/model_parallel.py``), each rank one
process, the collectives on the mesh's group:

* **tp**: a Megatron column/row-parallel MLP. The first matmul's output
  features and the second's input features are split over ``model``, so
  one all-reduce at the end makes the activations whole.
* **pp**: a GPipe schedule. Identical stages stacked on axis 0, one a rank;
  the activations of a microbatch go from stage i to i+1 point to point at
  each of the ``M + S - 1`` schedule steps, and the last stage's outputs
  are all-reduced to every rank (the other stages contribute zeros).
* **ep**: a top-1 routed mixture of experts. The experts are split over
  ``model``; every rank runs its experts on all tokens, masks by the
  router's choice, and an all-reduce combines.

Parameters are dicts of tensors: full tensors (the same on every rank, each
rank takes its split) or DTensors (:func:`shard_params`). ``*_init`` fill
them from an explicit ``torch.Generator`` (other numbers than
``jax.random``'s); :func:`from_jax_params` carries the JAX package's
parameters across. ``*_reference`` are the single-device oracles.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

from wicca_tpu_torch.comm import all_reduce_, chunk_bounds, exchange
from wicca_tpu_torch.parallel.mesh import _device_mesh, _world_size, mesh_device, mesh_device_type

MODEL_AXIS = "model"


def model_mesh(device_type=None):
    """1-D mesh over every rank of the world for the tp/pp/ep passes."""
    return _device_mesh(mesh_device_type(device_type), (_world_size(),), (MODEL_AXIS,), None)


def from_jax_params(tree: dict) -> dict:
    """The JAX package's parameter dict (numpy arrays, or anything
    ``np.asarray`` takes) as CPU tensors; the layouts are the same."""
    return {k: torch.from_numpy(np.array(v, copy=True)) for k, v in tree.items()}


def _split(t, placement, mesh) -> torch.Tensor:
    """This rank's split of ``t`` (a full tensor or a DTensor) on ``mesh``'s
    device."""
    if isinstance(t, DTensor):
        return t.to_local()
    if isinstance(placement, Shard):
        lo, hi = chunk_bounds(t.shape[placement.dim], mesh.size())[mesh.get_local_rank(MODEL_AXIS)]
        t = t.narrow(placement.dim, lo, hi - lo)
    return t.to(mesh_device(mesh))


def shard_params(params: dict, placements: dict, mesh) -> dict:
    """Full parameter tensors (the same on every rank) as DTensors on
    ``mesh`` with ``placements``, each rank keeping its split (no
    communication)."""
    out = {}
    for k, t in params.items():
        p = placements[k][0]
        local = _split(t, p, mesh).contiguous()
        out[k] = DTensor.from_local(local, mesh, [p], run_check=False, shape=t.shape, stride=t.stride())
    return out


# --------------------------------------------------------------------------
# Tensor parallelism (Megatron column/row-parallel MLP)
# --------------------------------------------------------------------------


def tp_mlp_init(generator: torch.Generator, d_in: int, d_hidden: int, d_out: int, dtype=torch.float32) -> dict:
    """Two-layer MLP parameters; the hidden dim is the split (tp) one."""
    return {
        "w1": (torch.randn(d_in, d_hidden, generator=generator) * (2.0 / d_in) ** 0.5).to(dtype),
        "b1": torch.zeros(d_hidden, dtype=dtype),
        "w2": (torch.randn(d_hidden, d_out, generator=generator) * (2.0 / d_hidden) ** 0.5).to(dtype),
        "b2": torch.zeros(d_out, dtype=dtype),
    }


def tp_mlp_placements() -> dict:
    """w1 column-parallel, w2 row-parallel, b2 replicated."""
    return {"w1": [Shard(1)], "b1": [Shard(0)], "w2": [Shard(0)], "b2": [Replicate()]}


def tp_mlp_apply(params: dict, x, mesh) -> torch.Tensor:
    """``relu(x @ w1 + b1) @ w2 + b2`` with the hidden dim split over
    ``model``; one all-reduce in all. The same tensor on every rank."""
    pl = tp_mlp_placements()
    w1, b1, w2, b2 = (_split(params[k], pl[k][0], mesh) for k in ("w1", "b1", "w2", "b2"))
    x = torch.as_tensor(x).to(w1.device)
    y = F.relu(x @ w1 + b1) @ w2  # a partial sum over this rank's hidden split
    return all_reduce_(y, mesh.get_group(MODEL_AXIS)) + b2


def tp_mlp_reference(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Single-device oracle of :func:`tp_mlp_apply`."""
    return F.relu(x @ params["w1"] + params["b1"]) @ params["w2"] + params["b2"]


# --------------------------------------------------------------------------
# Pipeline parallelism (GPipe schedule, point to point)
# --------------------------------------------------------------------------


def pp_stages_init(generator: torch.Generator, n_stages: int, d: int, dtype=torch.float32) -> dict:
    """``n_stages`` identical residual-MLP stages stacked on axis 0 (the
    split pp dim)."""
    w = torch.stack([torch.randn(d, d, generator=generator) * (1.0 / d) ** 0.5 for _ in range(n_stages)])
    return {"w": w.to(dtype), "b": torch.zeros(n_stages, d, dtype=dtype)}


def pp_stage_placements() -> dict:
    return {"w": [Shard(0)], "b": [Shard(0)]}


def _pp_stage(w, b, x):
    return x + F.relu(x @ w + b)


def pp_apply(params: dict, microbatches, mesh) -> torch.Tensor:
    """GPipe forward of ``microbatches`` ``(M, mb, d)`` (the same on every
    rank) through one stage a rank. At each of the ``M + S - 1`` steps stage
    i sends its output to stage i+1; stage 0 takes microbatch t from the
    feed while t < M, the others the wire (zeros before the first arrives).
    The last stage emitted microbatch m at step ``m + S - 1``; its outputs are
    all-reduced (zeros elsewhere), so every rank returns them."""
    n_stages = mesh.size()
    if params["w"].shape[0] != n_stages:
        # one stage a rank (w[0] of the split); a mismatch would split
        # cleanly and drop or duplicate stages without a word
        raise ValueError(f"pp_apply needs one stage per device: got {params['w'].shape[0]} stages on a "
                         f"{n_stages}-device '{MODEL_AXIS}' axis")
    pl = pp_stage_placements()
    w, b = (_split(params[k], pl[k][0], mesh)[0] for k in ("w", "b"))
    group = mesh.get_group(MODEL_AXIS)
    idx = mesh.get_local_rank(MODEL_AXIS)
    xs = torch.as_tensor(microbatches).to(w.device)
    n_micro = xs.shape[0]
    wire = torch.zeros_like(xs[0])
    ys = []
    for t in range(n_micro + n_stages - 1):
        y = _pp_stage(w, b, xs[min(t, n_micro - 1)] if idx == 0 and t < n_micro else wire)
        sends = {idx + 1: y} if idx < n_stages - 1 else {}
        recvs = {idx - 1: (tuple(y.shape), y.dtype)} if idx > 0 else {}
        got = exchange(sends, recvs, group, y.device)
        wire = got[idx - 1] if idx > 0 else torch.zeros_like(y)
        ys.append(y)
    outs = torch.stack(ys[n_stages - 1:])
    if idx != n_stages - 1:
        outs = torch.zeros_like(outs)
    return all_reduce_(outs, group)


def pp_reference(params: dict, microbatches: torch.Tensor) -> torch.Tensor:
    """Single-device oracle: every microbatch through all stages."""
    y = microbatches
    for w, b in zip(params["w"], params["b"]):
        y = _pp_stage(w, b, y)
    return y


# --------------------------------------------------------------------------
# Expert parallelism (top-1 routed MoE)
# --------------------------------------------------------------------------


def moe_init(generator: torch.Generator, n_experts: int, d: int, d_hidden: int, dtype=torch.float32) -> dict:
    s1, s2 = (2.0 / d) ** 0.5, (2.0 / d_hidden) ** 0.5
    return {
        "gate": (torch.randn(d, n_experts, generator=generator) * s1).to(dtype),
        "w1": (torch.randn(n_experts, d, d_hidden, generator=generator) * s1).to(dtype),
        "w2": (torch.randn(n_experts, d_hidden, d, generator=generator) * s2).to(dtype),
    }


def moe_placements() -> dict:
    return {"gate": [Replicate()], "w1": [Shard(0)], "w2": [Shard(0)]}


def _expert_ffn(w1, w2, x):
    return F.relu(x @ w1) @ w2


def _route(gate, x):
    logits = x @ gate
    return torch.argmax(logits, dim=-1), torch.softmax(logits, dim=-1).max(dim=-1).values


def moe_apply(params: dict, x, mesh) -> torch.Tensor:
    """Top-1 MoE forward: tokens ``(T, d)`` on every rank, the experts split
    over ``model``. Each rank runs its experts on all tokens, masks by the
    router, and the all-reduced sum is scaled by the gate probability."""
    pl = moe_placements()
    gate, w1, w2 = (_split(params[k], pl[k][0], mesh) for k in ("gate", "w1", "w2"))
    x = torch.as_tensor(x).to(gate.device)
    choice, prob = _route(gate, x)
    base = chunk_bounds(params["w1"].shape[0], mesh.size())[mesh.get_local_rank(MODEL_AXIS)][0]
    out = torch.zeros_like(x)
    for e in range(w1.shape[0]):
        out = out + _expert_ffn(w1[e], w2[e], x) * (choice == base + e).to(x.dtype)[:, None]
    return all_reduce_(out, mesh.get_group(MODEL_AXIS)) * prob[:, None]


def moe_reference(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Single-device oracle of :func:`moe_apply`."""
    choice, prob = _route(params["gate"], x)
    ys = torch.stack([_expert_ffn(w1, w2, x) for w1, w2 in zip(params["w1"], params["w2"])])  # (E, T, d)
    picked = ys[choice, torch.arange(x.shape[0])]
    return picked * prob[:, None]
