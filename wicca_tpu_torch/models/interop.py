"""Weights across the two packages: a Flax variable tree of the JAX zoo
(``wicca_tpu/models/flax_models.py``) as a state dict of the port's zoo
(:mod:`wicca_tpu_torch.models.nets`), and back (the model counterpart of
``codec/interop.py``).

A tree is ``{'params': ..., 'batch_stats': ...}`` as nested dicts of numpy
arrays, keyed by Flax's module names, which the port's modules share; the
path ``params/_InvertedResidual_3/_ConvBN_1/Conv_0/kernel`` is the state
dict key ``_InvertedResidual_3._ConvBN_1.Conv_0.weight``. The layouts:

* conv kernel HWIO -> OIHW (a depthwise ``(kh, kw, 1, C)`` -> ``(C, 1, kh, kw)``);
* dense kernel ``(in, out)`` -> ``(out, in)``;
* attention ``query``/``key``/``value`` kernels ``(dim, heads, head_dim)`` ->
  ``(heads*head_dim, dim)``, their biases ``(heads, head_dim)`` flattened; the
  ``out`` kernel ``(heads, head_dim, dim)`` -> ``(dim, heads*head_dim)``;
* BatchNorm ``scale``/``bias`` (params) and ``mean``/``var`` (batch_stats) ->
  ``weight``/``bias``/``running_mean``/``running_var``; LayerNorm
  ``scale``/``bias`` -> ``weight``/``bias``;
* ViT's ``cls`` and ``pos_embed`` unchanged.

Every leaf is checked for its shape, and every entry of the model's state
dict must be covered.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from wicca_tpu_torch.models import nets

# (collection, Flax leaf) -> state dict leaf, per normalization layer
_NORM = {("params", "scale"): "weight", ("params", "bias"): "bias", ("batch_stats", "mean"): "running_mean",
         ("batch_stats", "var"): "running_var"}


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) or type(v).__name__ == "FrozenDict":
            yield from _leaves(v, (*prefix, k))
        else:
            yield (*prefix, k), v


def _float32(value) -> np.ndarray:
    """A leaf as float32 numpy (a bfloat16 tensor, as a weights file gives
    it, widened exactly)."""
    if isinstance(value, torch.Tensor):
        return value.detach().to("cpu", torch.float32).numpy()
    return np.asarray(value, dtype=np.float32)


def _to_torch(module: nn.Module, parent: nn.Module | None, name: str, col: str, leaf: str, a: np.ndarray):
    """(state dict leaf, array in the port's layout) of one Flax leaf."""
    if isinstance(module, (nets.BatchNorm, nets.LayerNorm)):
        return _NORM[(col, leaf)], a
    if col != "params":
        raise KeyError(f"{col}/{leaf}")
    if isinstance(module, nets.Conv) and leaf == "kernel":
        return "weight", np.transpose(a, (3, 2, 0, 1))
    if isinstance(module, nets.Dense) and leaf == "kernel":
        if isinstance(parent, nets.MultiHeadDotProductAttention):
            a = a.reshape(-1, a.shape[-1]) if name == "out" else a.reshape(a.shape[0], -1)
        return "weight", a.T
    if isinstance(module, (nets.Conv, nets.Dense)) and leaf == "bias":
        return "bias", a.reshape(-1)
    if isinstance(module, nets.ViT) and leaf in ("cls", "pos_embed"):
        return leaf, a
    raise KeyError(f"{col}/{leaf} of a {type(module).__name__}")


def carry(variables, template: nn.Module) -> dict[str, torch.Tensor]:
    """The state dict of ``template`` (a zoo model, on any device, the
    ``meta`` device included) holding the Flax ``variables``; raises on a
    leaf with no place in the model, a shape mismatch or a state dict entry
    left uncovered."""
    want = template.state_dict()
    modules = dict(template.named_modules())
    out: dict[str, torch.Tensor] = {}
    for col in ("params", "batch_stats"):
        for path, value in _leaves(variables.get(col, {})):
            mpath = ".".join(path[:-1])
            if mpath not in modules:
                raise ValueError(f"flax {col}/{'/'.join(path)}: no module {mpath!r} in {type(template).__name__}")
            parent = modules[".".join(path[:-2])] if len(path) > 1 else None
            try:
                leaf, arr = _to_torch(modules[mpath], parent, path[-2] if len(path) > 1 else "", col, path[-1],
                                      _float32(value))
            except KeyError as e:
                raise ValueError(f"flax {col}/{'/'.join(path)}: no counterpart ({e})") from None
            key = f"{mpath}.{leaf}" if mpath else leaf
            if key not in want:
                raise ValueError(f"flax {col}/{'/'.join(path)}: no state dict entry {key!r}")
            if tuple(arr.shape) != tuple(want[key].shape):
                raise ValueError(f"shape mismatch at {key}: flax {col}/{'/'.join(path)} gives {arr.shape}, "
                                 f"the model wants {tuple(want[key].shape)}")
            out[key] = torch.from_numpy(np.array(arr, dtype=np.float32, order="C"))  # a copy: the tree stays
    missing = [k for k in want if k not in out]
    if missing:
        raise ValueError(f"{len(missing)} state dict entries not covered by the flax variables: {missing[:6]}")
    return {k: out[k] for k in want}  # in the model's order


def from_flax_variables(arch: str, variables, shape: tuple[int, int] = (224, 224)) -> dict[str, torch.Tensor]:
    """The state dict of the port's ``arch`` (a registered architecture
    name) holding the Flax ``variables`` of the JAX zoo's model of the same
    name; ``shape`` is the (H, W) its variables were made for (VGG's first
    dense layer and ViT's position embedding depend on it). The result
    passes ``load_state_dict(strict=True)``."""
    from wicca_tpu_torch.models.registry import build

    with torch.device("meta"):
        template = build(arch, shape)
    return carry(variables, template)


def to_flax_variables(model: nn.Module) -> dict:
    """The inverse of :func:`carry`: ``model``'s weights as a Flax
    ``{'params', 'batch_stats'}`` tree of float32 numpy arrays."""
    tree: dict = {"params": {}, "batch_stats": {}}
    modules = dict(model.named_modules())
    for key, value in model.state_dict().items():
        mpath, _, leaf = key.rpartition(".")
        module = modules[mpath]
        parent = modules[mpath.rpartition(".")[0]] if mpath else None
        attn = isinstance(parent, nets.MultiHeadDotProductAttention)
        out_proj = attn and mpath.endswith(".out")
        a = value.detach().to("cpu", torch.float32).numpy()
        col = "params"
        if isinstance(module, (nets.BatchNorm, nets.LayerNorm)):
            col, leaf = next(k for k, v in _NORM.items() if v == leaf)
        elif leaf == "weight":
            a = np.transpose(a, (2, 3, 1, 0)) if isinstance(module, nets.Conv) else a.T
            if attn:
                a = a.reshape(parent.heads, -1, a.shape[-1]) if out_proj else a.reshape(a.shape[0], parent.heads, -1)
            leaf = "kernel"
        elif leaf == "bias" and attn and not out_proj:
            a = a.reshape(parent.heads, -1)
        node = tree[col]
        for part in (mpath.split(".") if mpath else []):
            node = node.setdefault(part, {})
        node[leaf] = np.ascontiguousarray(a)
    if not tree["batch_stats"]:
        del tree["batch_stats"]
    return tree
