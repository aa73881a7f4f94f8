"""Classifier registry (counterpart of ``wicca_tpu/models/registry.py``).

``load_single_model`` / ``load_models`` return the reference's dict
contract, ``{MODEL, PRE_INP, DEC_PRED, SHAPE}``, where MODEL is a callable
NHWC float32 batch -> float32 logits (numpy in, numpy out). The zoo models
(:mod:`wicca_tpu_torch.models.nets`) run on ``device``: CUDA unless the
caller passes ``device='cpu'``; with no card and no explicit CPU device the
loaders raise. Weights come from ``WICCA_TPU_WEIGHTS/<name>.msgpack`` (the
JAX package's file, flax's msgpack bytes of its variables, as both
packages' ``convert_h5`` write it, read by
:mod:`wicca_tpu_torch.models.flax_msgpack` and carried by
:mod:`wicca_tpu_torch.models.interop`), else from
``WICCA_TPU_WEIGHTS/<name>.pt`` (a state dict), else from a
deterministic init: a ``torch.Generator`` seeded with the JAX
package's per-name seed (the first four bytes of the name's sha256). The
values of that init differ from the JAX package's, which draws from
``jax.random``.

A bad name or an unreadable weights file (one that misses a layer or has
a leaf of another shape) is logged and gives ``None``, the reference's
contract; a device fault (no card, a CUDA error while moving the model)
raises.
"""

from __future__ import annotations

import contextlib
import hashlib
import inspect
import logging
import os
import threading
from pathlib import Path
from typing import Any

import numpy as np
import torch
from torch import nn

from wicca_tpu_torch._device import download, host_data_device, upload
from wicca_tpu_torch.config.aliases import ModelsDict
from wicca_tpu_torch.config.constants import DEC_PRED, MODEL, PRE_INP, SHAPE
from wicca_tpu_torch.models import flax_msgpack, interop, nasnet_keras, nets
from wicca_tpu_torch.models.imagenet import decode_predictions
from wicca_tpu_torch.utils.timing import count, span

# ---------------------------------------------------------------------------
# Preprocessing (per architecture, the Keras conventions)
# ---------------------------------------------------------------------------


def preprocess_minus1_1(x: np.ndarray) -> np.ndarray:
    """[0,255] -> [-1,1] (Keras 'tf' mode: MobileNet/Inception families)."""
    return np.asarray(x, dtype=np.float32) / 127.5 - 1.0


def preprocess_caffe(x: np.ndarray) -> np.ndarray:
    """RGB->BGR + ImageNet mean subtraction (Keras 'caffe' mode: VGG/ResNet)."""
    x = np.asarray(x, dtype=np.float32)[..., ::-1]
    return x - np.array([103.939, 116.779, 123.68], dtype=np.float32)


def preprocess_torch(x: np.ndarray) -> np.ndarray:
    """[0,1] + ImageNet mean/std normalize (Keras 'torch' mode: EfficientNet+DenseNet)."""
    x = np.array(x, dtype=np.float32)  # one copy; the steps below (the JAX package's, in its order) work in it
    x /= 255.0
    x -= np.array([0.485, 0.456, 0.406], dtype=np.float32)
    x /= np.array([0.229, 0.224, 0.225], dtype=np.float32)
    return x


class StreamLender:
    """Idle streams, lent one to each call: a call takes the stream that was
    given back last (or a new one from ``make`` where none is idle) and gives
    it back when it ends. Calls that follow one another, from whichever
    thread, run on one stream, so the CUDA caching allocator, which reuses a
    block only on the stream it was allocated on, serves each call from the
    blocks of the last; calls at the same time get streams of their own."""

    def __init__(self, make):
        self._make = make
        self._idle: list = []
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def lend(self):
        with self._lock:
            stream = self._idle.pop() if self._idle else self._make()
        try:
            yield stream
        finally:
            with self._lock:
                self._idle.append(stream)


class TorchClassifier:
    """Callable classifier: ``model(batch_nhwc_f32) -> logits np.ndarray``.

    Each call copies the numpy batch to the model's device, runs the
    forward under ``torch.inference_mode()`` and copies the float32 logits
    back: the spans ``model.upload``, ``model.forward`` (the forward's host
    dispatch) and ``model.fetch``, and the counter ``model.images``. On a
    card a call queues its work on a CUDA stream lent to it for the call
    (:class:`StreamLender`) and waits only for its own copy back, so calls
    from several threads at once overlap on one card, and calls one after
    another reuse one stream's memory.
    """

    def __init__(self, name: str, module: nn.Module, input_shape: tuple[int, int], device: torch.device):
        self.name = name
        self.module = module
        self.input_shape = input_shape
        self.device = device
        self._streams = StreamLender(lambda: torch.cuda.Stream(self.device))

    def _forward(self, batch: np.ndarray) -> np.ndarray:
        with span("model.upload"):
            x = upload(np.asarray(batch, dtype=np.float32), self.device)
        with span("model.forward"), torch.inference_mode():
            logits = self.module(x.permute(0, 3, 1, 2))
        with span("model.fetch"):
            out = download(logits.float())
        count("model.images", len(batch))
        return out

    def __call__(self, batch: np.ndarray) -> np.ndarray:
        if self.device.type != "cuda":
            return self._forward(batch)
        with self._streams.lend() as stream, torch.cuda.device(self.device), torch.cuda.stream(stream):
            return self._forward(batch)


_ARCHITECTURES: dict[str, tuple[Any, Any]] = {
    # name -> (module factory, preprocess fn)
    "MobileNetV2": (nets.MobileNetV2, preprocess_minus1_1),
    "ResNet50": (nets.ResNet50, preprocess_caffe),
    "EfficientNetB0": (nets.EfficientNetB0, preprocess_torch),
    "SimpleCNN": (nets.SimpleCNN, preprocess_minus1_1),
    "VGG16": (nets.VGG16, preprocess_caffe),
    "VGG19": (nets.VGG19, preprocess_caffe),
    "DenseNet121": (nets.DenseNet121, preprocess_torch),
    # the checkpoint graph, so that converted hosted weights load; the
    # paper-cell variant is nets.NASNetMobile
    "NASNetMobile": (nasnet_keras.NASNetMobileKeras, preprocess_minus1_1),
    "ViTS16": (nets.ViTS16, preprocess_minus1_1),
    "ViTTiny16": (nets.ViTTiny16, preprocess_minus1_1),
    # the port's own names, after the JAX package's
    "SwinL384": (nets.SwinL384, preprocess_torch),
    "MaxViTXL512": (nets.MaxViTXL512, preprocess_minus1_1),  # the TF release's mean 0.5 and std 0.5
}


def register_architecture(name: str, module_factory, preprocess) -> None:
    """Extension point for user model families: ``module_factory()`` returns
    an ``nn.Module`` taking an NCHW float32 batch."""
    _ARCHITECTURES[name] = (module_factory, preprocess)


def available_architectures() -> tuple[str, ...]:
    return tuple(_ARCHITECTURES)


def _instantiate(factory, shape: tuple[int, int], **kw) -> nn.Module:
    """``factory(**kw)``, with ``image_size=shape`` where the factory takes
    it (VGG's and ViT's sizes follow the input)."""
    try:
        takes = "image_size" in inspect.signature(factory).parameters
    except (TypeError, ValueError):  # a callable without a signature
        takes = False
    return factory(image_size=tuple(shape), **kw) if takes else factory(**kw)


def build(arch: str, shape: tuple[int, int] = (224, 224), **kw) -> nn.Module:
    """A registered architecture's module, parameters uninitialized (on
    the default device, ``meta`` included)."""
    return _instantiate(_ARCHITECTURES[arch][0], shape, **kw)


def seed_for(name: str) -> int:
    """The per-name init seed (the JAX package's: sha256 of the name, first
    four bytes, little-endian)."""
    return int.from_bytes(hashlib.sha256(name.encode()).digest()[:4], "little")


def _init_params(name: str, module: nn.Module) -> nn.Module:
    weights_dir = os.environ.get("WICCA_TPU_WEIGHTS")
    if weights_dir:
        # the JAX package's file first, so both packages read the same weights
        path = Path(weights_dir) / f"{name}.msgpack"
        if path.is_file():
            module.load_state_dict(interop.carry(flax_msgpack.read(path.read_bytes()), module), strict=True)
            return module
        pt = path.with_suffix(".pt")
        if pt.is_file():
            module.load_state_dict(torch.load(pt, map_location="cpu", weights_only=True), strict=True)
            return module
        logging.warning(f"No weights file for {name} at {path} or {pt}; using deterministic init")
    return nets.init_weights(module, torch.Generator().manual_seed(seed_for(name)))


def load_single_model(model_class, shape: tuple[int, int] = (224, 224), weights: str = "imagenet",
                      device=None) -> dict | None:
    """Reference-parity loader: the {MODEL, PRE_INP, DEC_PRED, SHAPE} dict, or
    None (logged) for a bad name or an unreadable weights file.

    ``model_class`` may be a registered architecture name, a module
    class/factory of :mod:`wicca_tpu_torch.models.nets`, or any callable
    returning logits (a Keras-like model, used as-is with the default
    preprocessing). The model runs on ``device`` (CUDA unless the caller
    passes ``device='cpu'``); a device fault raises.
    """
    dev = host_data_device(device)
    try:
        if isinstance(model_class, str):
            name = model_class
            factory, pre = _ARCHITECTURES[name]
            module = _instantiate(factory, shape)
        else:
            name = getattr(model_class, "__name__", type(model_class).__name__)
            if name in _ARCHITECTURES:
                factory, pre = _ARCHITECTURES[name]
                module = _instantiate(factory, shape)
            else:
                module = model_class() if isinstance(model_class, type) or callable(model_class) else model_class
                pre = preprocess_minus1_1
        if not isinstance(module, nn.Module):
            # duck-typed external model (e.g. a Keras model instance): used as
            # the batch->logits callable directly
            model = lambda batch, _m=module: np.asarray(_m(np.asarray(batch, dtype=np.float32)))  # noqa: E731
            return {MODEL: model, PRE_INP: pre, DEC_PRED: decode_predictions, SHAPE: shape}
        module = _init_params(name, module).eval()
    except Exception as e:  # noqa: BLE001  (reference contract: log + None)
        logging.error(f"Error loading: {e}")
        return None
    module = module.to(dev)  # outside the try: a device fault raises
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)  # the weights are in place before any thread's stream reads them
    return {MODEL: TorchClassifier(name, module, shape, dev), PRE_INP: pre, DEC_PRED: decode_predictions,
            SHAPE: shape}


def load_models(models: ModelsDict, device=None) -> dict[str, Any]:
    """Reference-parity multi-loader: dict of name -> class or (class,
    kwargs), with a progress bar; every model on ``device``."""
    from tqdm.auto import tqdm

    host_data_device(device)
    classifiers: dict[str, Any] = {}
    for name, info in tqdm(models.items(), desc="loading model zoo"):
        if isinstance(info, tuple):
            model_class, kwargs = info
        else:
            model_class, kwargs = info, {}
        classifiers[name] = load_single_model(model_class, **{"device": device, **kwargs})
    return classifiers
