"""Classifier fine-tuning on wavelet icons (counterpart of
``wicca_tpu/harness/train.py``).

* dataset: ImageFolder layout (``root/<class_name>/*.png``), decoded on host
  threads a few images ahead; the icons of each batch are computed on
  ``device`` in one call (K1 on a card, its plain twin for ``device='cpu'``),
  then resized on the host (cv2 ``INTER_AREA``) and scaled to [-1, 1]; the
  trailing partial batch is dropped; at most one batch of pixels is held;
* step: mean softmax cross-entropy over integer labels, gradients by
  autograd, Adam as optax computes it (:class:`OptaxAdam`), on one device;
* the trained state is the JAX trainer's: its step differentiates the whole
  variable tree, so Adam updates the BatchNorm running statistics as well as
  the parameters (the modules normalize with them, so they get gradients);
  here they are buffers that require a gradient, normalized in Flax's
  differentiable form (:class:`~wicca_tpu_torch.models.nets.BatchNorm`);
* checkpoints: ``torch.save`` of ``{"params": state dict (BatchNorm
  statistics included), "opt_state", "step"}`` in ``<dir>/step_<n>/`` (orbax's
  format is not read: orbax is a JAX library).

Runs on CUDA unless the caller passes ``device='cpu'``; with no card and no
explicit CPU device it raises.

Data parallel (the JAX trainer's ``mesh``): every rank of a
:func:`~wicca_tpu_torch.parallel.mesh.make_mesh` or ``data_mesh`` calls
:func:`finetune_on_icons` with it. The batch is split over the ``data`` dim:
every rank draws the same permutation, and the global batches are the JAX
trainer's (the next ``batch_size`` readable images; the ranks agree on
which are readable with one all-reduce of flags a batch); each rank
decodes and icons only its own rows; the gradients of every tensor
:func:`trainable` returns (BatchNorm statistics included) are averaged in
one flattened all-reduce, so every rank takes the same step and holds the
same state (not DDP, which broadcasts buffers instead of training them);
the loss history is the global mean; rank 0 writes the checkpoints.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from wicca_tpu_torch._device import host_data_device


@dataclasses.dataclass
class TrainConfig:
    architecture: str = "SimpleCNN"
    input_size: int = 64
    depth: int = 3
    batch_size: int = 32
    learning_rate: float = 1e-3
    epochs: int = 1
    seed: int = 0
    checkpoint_dir: str | None = None


def _scan_dataset(root: Path):
    """ImageFolder scan: (files, labels, class names). Only paths are held
    in memory; pixels stream per batch."""
    from wicca_tpu_torch.data.loader import list_images

    classes = sorted(p.name for p in Path(root).iterdir() if p.is_dir())
    if not classes:
        raise ValueError(f"{root} has no class subfolders (ImageFolder layout)")
    files, labels = [], []
    for label, cname in enumerate(classes):
        for f in list_images(Path(root) / cname):
            files.append(f)
            labels.append(label)
    return files, np.asarray(labels, np.int32), classes


def _model_input(imgs, input_size: int, depth: int, device) -> np.ndarray:
    """The icons of a batch, computed in one call on ``device``, resized on
    host and scaled to [-1, 1] (NHWC float32)."""
    import cv2

    from wicca_tpu_torch.harness.processor import _compute_icons_batched

    icons = _compute_icons_batched(imgs, depth, device)
    return np.stack([
        cv2.resize(ic, (input_size, input_size), interpolation=3) for ic in icons
    ]).astype(np.float32) / 127.5 - 1.0


def _iter_batches(files, labels, input_size: int, depth: int, bs: int, order, device=None):
    """Stream one epoch: threaded decode runs ahead (a few images
    resident), each batch of ``bs`` readable images in ``order`` goes
    through :func:`_model_input`. Trailing partial batches are dropped, as
    the JAX trainer drops them to keep its compiled step's shapes."""
    from wicca_tpu_torch.data.loader import iter_decoded

    sel = [files[i] for i in order]
    ysel = labels[order]
    buf_imgs, buf_ys = [], []
    for (_, img), label in zip(iter_decoded(sel), ysel):
        if img is None:
            continue
        buf_imgs.append(img)
        buf_ys.append(label)
        if len(buf_imgs) < bs:
            continue
        yield _model_input(buf_imgs, input_size, depth, device), np.asarray(buf_ys, np.int32)
        buf_imgs, buf_ys = [], []


def _iter_mesh_batches(files, labels, input_size: int, depth: int, bs: int, order, group, rank: int, device):
    """This rank's rows ``rank * share : (rank + 1) * share`` of each of the
    JAX trainer's global batches: the next ``bs`` readable images in
    ``order`` (an unreadable one is skipped and the batch filled from the
    images after it), trailing partial batch dropped.

    The ranks agree on which images are readable: each decodes the
    candidates that would fall in its own rows, and one all-reduce of
    ``bs`` flags over ``group`` tells every rank about all of them (another
    round only after an unreadable image). A rank whose rows shifted onto
    another rank's candidates reads those again. Decodes run on 8 threads
    (as :func:`~wicca_tpu_torch.data.loader.iter_decoded`), a batch ahead."""
    from concurrent.futures import ThreadPoolExecutor

    from wicca_tpu_torch.comm import all_reduce_
    from wicca_tpu_torch.data.loader import load_image

    share = bs // dist.get_world_size(group)
    mine = range(rank * share, (rank + 1) * share)
    n, pos = len(order), 0
    with ThreadPoolExecutor(max_workers=8) as pool:
        loads: dict = {}

        def load(p):
            if p not in loads:
                loads[p] = pool.submit(load_image, files[order[p]])
            return loads[p]

        while True:
            ready: list = []  # the batch's readable positions in order
            while len(ready) < bs and pos < n:
                cand = range(pos, min(n, pos + bs - len(ready)))
                own = {p for i, p in enumerate(cand) if len(ready) + i in mine}
                for p in own:
                    load(p)
                flags = torch.tensor([int(p in own and load(p).result() is not None) for p in cand],
                                     dtype=torch.int32, device=device)
                flags = all_reduce_(flags, group).tolist()
                ready += [p for p, f in zip(cand, flags) if f]
                pos = cand.stop
            if len(ready) < bs:
                return
            for p in range(pos + rank * share, min(n, pos + (rank + 1) * share)):
                load(p)  # the next batch's rows if every image is readable
            rows = [ready[i] for i in mine]
            imgs = [load(p).result() for p in rows]
            if any(img is None for img in imgs):
                raise RuntimeError(f"an image another rank read is unreadable here: "
                                   f"{[files[order[p]] for p, img in zip(rows, imgs) if img is None]}")
            for p in [p for p in loads if p < pos]:
                loads.pop(p).cancel()
            yield _model_input(imgs, input_size, depth, device), labels[order[rows]].astype(np.int32)


def init_model(config: TrainConfig, num_classes: int) -> nn.Module:
    """The model to train, on the CPU: ``config.architecture`` of the zoo's
    modules (as the JAX trainer takes it from ``flax_models``: NASNetMobile
    is the paper-cell graph, NASNetMobileKeras the checkpoint graph), at
    ``config.input_size``, filled by :func:`~wicca_tpu_torch.models.nets.init_weights`
    from ``torch.Generator().manual_seed(config.seed)``. The values differ
    from the JAX trainer's ``jax.random`` init."""
    from wicca_tpu_torch.models import nasnet_keras, nets
    from wicca_tpu_torch.models.registry import _instantiate

    factory = getattr(nets, config.architecture, None) or getattr(nasnet_keras, config.architecture)
    model = _instantiate(factory, (config.input_size, config.input_size), num_classes=num_classes)
    return nets.init_weights(model, torch.Generator().manual_seed(config.seed))


B1, B2, EPS = 0.9, 0.999, 1e-8  # optax.adam's defaults, which the JAX trainer uses


class OptaxAdam(torch.optim.Optimizer):
    """``optax.adam(lr)`` (b1 0.9, b2 0.999, eps 1e-8, eps_root 0), its
    operations in its order, each rounded to float32:
    ``mu = (1-b1) g + b1 mu``, ``nu = (1-b2) g*g + b2 nu``, the bias
    corrections ``1 - b**count`` in float32, ``u = mu_hat / (sqrt(nu_hat) + eps)``,
    ``p = p + (-lr) u``. A tensor with no gradient takes a zero gradient,
    as every leaf of the JAX tree has one."""

    def __init__(self, params, lr: float = 1e-3):
        super().__init__(params, dict(lr=lr))

    @torch.no_grad()
    def step(self, closure=None):
        corrections: dict = {}  # (count, device) -> the two bias corrections, on the device
        for group in self.param_groups:
            lr = group["lr"]
            for p in group["params"]:
                st = self.state[p]
                if not st:
                    st["count"] = 0
                    st["mu"] = torch.zeros_like(p)
                    st["nu"] = torch.zeros_like(p)
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                st["count"] += 1
                st["mu"] = (1 - B1) * g + B1 * st["mu"]
                st["nu"] = (1 - B2) * (g * g) + B2 * st["nu"]
                key = (st["count"], p.device)
                if key not in corrections:
                    # 0-dim tensors on the device: a CUDA division by a host
                    # scalar multiplies by its reciprocal instead
                    count = torch.tensor(float(st["count"]))
                    corrections[key] = tuple((1 - torch.tensor(b) ** count).to(p.device) for b in (B1, B2))
                c1, c2 = corrections[key]
                p.add_(-lr * ((st["mu"] / c1) / (torch.sqrt(st["nu"] / c2) + EPS)))


def trainable(model: nn.Module) -> list[torch.Tensor]:
    """Every tensor of ``model``'s state dict, in its order: the parameters
    and the BatchNorm running statistics, the latter made to require a
    gradient (the JAX trainer's step differentiates its whole variable
    tree)."""
    state = list(model.state_dict(keep_vars=True).values())
    for t in state:
        t.requires_grad_(True)
    return state


def average_gradients(opt: torch.optim.Optimizer, loss: torch.Tensor, group) -> torch.Tensor:
    """Average the gradients of every tensor ``opt`` steps (a zero gradient
    where there is none) and ``loss`` over ``group`` in one flattened
    all-reduce; returns the averaged loss."""
    from wicca_tpu_torch.comm import all_reduce_

    params = [p for g in opt.param_groups for p in g["params"]]
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    flat = torch.cat([g.reshape(-1).float() for g in grads] + [loss.detach().reshape(1).float()])
    flat = all_reduce_(flat, group) / dist.get_world_size(group)
    off = 0
    for p in params:
        p.grad = flat[off : off + p.numel()].view_as(p).to(p.dtype)
        off += p.numel()
    return flat[-1]


def train_step(model: nn.Module, opt: torch.optim.Optimizer, xb: torch.Tensor, yb: torch.Tensor,
               group=None) -> torch.Tensor:
    """One step on an NCHW float32 batch and int64 labels: mean softmax
    cross-entropy, its gradients (averaged over ``group`` when one is
    given: this rank's rows are its share of the batch), one optimizer
    step. Returns the loss (the group's mean)."""
    opt.zero_grad(set_to_none=True)
    loss = F.cross_entropy(model(xb).float(), yb)
    loss.backward()
    if group is not None:
        loss = average_gradients(opt, loss, group)
    opt.step()
    return loss.detach()


def _data_split(mesh, device):
    """(device, data group, rank's index on ``data``, ``data`` size) of a
    mesh; (``device`` under the device rule, None, 0, 1) without one."""
    if mesh is None:
        return host_data_device(device), None, 0, 1
    from torch.distributed.device_mesh import DeviceMesh

    from wicca_tpu_torch.parallel.mesh import DATA_AXIS, axis_size, mesh_device

    if not isinstance(mesh, DeviceMesh) or DATA_AXIS not in (mesh.mesh_dim_names or ()):
        raise TypeError(f"mesh must be a DeviceMesh with a '{DATA_AXIS}' dim "
                        f"(wicca_tpu_torch.parallel.make_mesh or data_mesh), got {type(mesh).__name__}")
    dev = mesh_device(mesh)
    if device is not None and torch.device(device).type != dev.type:
        raise ValueError(f"device={device!r}, but the mesh lies on {mesh.device_type}")
    return dev, mesh.get_group(DATA_AXIS), mesh.get_local_rank(DATA_AXIS), axis_size(mesh, DATA_AXIS)


def finetune_on_icons(data_root: str | Path, config: TrainConfig = TrainConfig(), mesh=None, device=None):
    """Train ``config.architecture`` to classify depth-d icons of the images
    under ``data_root`` (ImageFolder layout) on ``device``, or data parallel
    over ``mesh``'s ``data`` dim (every rank calls it; see the module
    docstring). Returns ``(state dict, {"classes", "history"})``;
    ``history`` holds each epoch's mean loss and seconds, as the JAX
    trainer's does."""
    dev, group, rank, ndev = _data_split(mesh, device)
    files, labels, classes = _scan_dataset(Path(data_root))
    n = len(files)
    model = init_model(config, len(classes)).to(dev)
    opt = OptaxAdam(trainable(model), config.learning_rate)
    bs = max(config.batch_size // ndev * ndev, ndev)  # the JAX trainer's device-aligned size
    if n < bs:
        raise ValueError(f"dataset has {n} images but the (device-aligned) batch size is {bs}")
    rng_np = np.random.default_rng(config.seed)
    history = []
    step_i = 0
    for epoch in range(config.epochs):
        order = rng_np.permutation(n)
        t0 = time.time()
        losses = []
        if group is None:
            batches = _iter_batches(files, labels, config.input_size, config.depth, bs, order, dev)
        else:
            batches = _iter_mesh_batches(files, labels, config.input_size, config.depth, bs, order, group, rank, dev)
        for xb_np, yb_np in batches:
            xb = torch.from_numpy(xb_np).to(dev).permute(0, 3, 1, 2)
            yb = torch.from_numpy(yb_np).to(dev, torch.int64)
            losses.append(float(train_step(model, opt, xb, yb, group)))
            step_i += 1
        history.append({"epoch": epoch, "loss": float(np.mean(losses)) if losses else None, "s": time.time() - t0})
        logging.info(f"epoch {epoch}: loss {history[-1]['loss']}")
        if config.checkpoint_dir and (mesh is None or dist.get_rank() == 0):
            save_checkpoint(config.checkpoint_dir, model.state_dict(), opt.state_dict(), step_i)
    return model.state_dict(), {"classes": classes, "history": history}


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def save_checkpoint(ckpt_dir: str | Path, params, opt_state, step: int) -> None:
    """The full train state, its tensors on the CPU, in
    ``<ckpt_dir>/step_<step>/state.pt`` (an existing one is replaced)."""
    path = Path(ckpt_dir).resolve() / f"step_{step}"
    path.mkdir(parents=True, exist_ok=True)
    tmp = path / "state.pt.tmp"
    torch.save({"params": _to_cpu(params), "opt_state": _to_cpu(opt_state), "step": step}, tmp)
    tmp.replace(path / "state.pt")


def restore_checkpoint(ckpt_dir: str | Path, template=None) -> dict:
    """The latest checkpoint under ``ckpt_dir`` (the highest ``step_<n>``),
    its tensors on the CPU. A ``template`` (a state as saved, or its
    ``params`` alone) must have the same parameter names and shapes."""
    root = Path(ckpt_dir).resolve()
    steps = sorted(root.glob("step_*"), key=lambda p: int(p.name.split("_")[1]))
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {root}")
    state = torch.load(steps[-1] / "state.pt", map_location="cpu", weights_only=True)
    if template is not None:
        want = template.get("params", template)
        got = {k: tuple(v.shape) for k, v in state["params"].items()}
        if got != {k: tuple(v.shape) for k, v in want.items()}:
            raise ValueError(f"{steps[-1]}: its parameters do not match the template's")
    return state
