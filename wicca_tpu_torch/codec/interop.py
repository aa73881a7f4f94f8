"""Carry a :class:`~wicca_tpu_torch.codec.pipeline.CodeStream` across to
the JAX package and back.

The codec has no weights: what crosses between the packages is the stream.
Both sides speak numpy arrays plus the stream's meta fields, so this module
needs neither JAX nor the JAX package:

* :func:`stream_to_arrays` turns a port stream into ``(ll, details, meta)``
  with numpy arrays and a ``meta`` dict whose ``spec`` is a plain dict of the
  ``QuantSpec`` fields (``coeff_dtype`` as a dtype name);
* :func:`stream_from_arrays` builds a port stream from such arrays and meta
  fields. ``spec`` may be a port ``QuantSpec``, a dict of its fields, or any
  object with those attributes (the JAX ``QuantSpec`` among them).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from wicca_tpu_torch._device import host_data_device
from wicca_tpu_torch.codec.pipeline import CodeStream
from wicca_tpu_torch.core.quant import QuantSpec

_SPEC_FIELDS = ("base_step", "level_gain", "ll_step", "coeff_dtype", "hh_gain")
_META_FIELDS = tuple(f.name for f in dataclasses.fields(CodeStream) if f.name not in ("ll", "details"))


def _torch_dtype(dt) -> torch.dtype:
    if isinstance(dt, torch.dtype):
        return dt
    return getattr(torch, np.dtype(dt).name)


def _spec_from(spec) -> QuantSpec:
    if isinstance(spec, QuantSpec):
        return spec
    get = spec.get if isinstance(spec, dict) else (lambda name: getattr(spec, name))
    fields = {name: get(name) for name in _SPEC_FIELDS}
    fields["coeff_dtype"] = _torch_dtype(fields["coeff_dtype"])
    return QuantSpec(**fields)


def stream_from_arrays(ll, details, device=None, **meta) -> CodeStream:
    """A port stream from numpy (or array-like) bands plus meta fields.
    The tensors go to ``device`` (CUDA unless the caller says otherwise)."""
    unknown = set(meta) - set(_META_FIELDS)
    if unknown:
        raise TypeError(f"unknown CodeStream fields: {sorted(unknown)}")
    dev = host_data_device(device)

    def t(a):
        return torch.from_numpy(np.array(a, order="C")).to(dev)  # a writable copy

    if "spec" in meta:
        meta["spec"] = _spec_from(meta["spec"])
    for name in ("orig_shape", "band_div"):
        if name in meta:
            meta[name] = tuple(int(v) for v in meta[name])
    return CodeStream(ll=t(ll), details=tuple(tuple(t(b) for b in bands) for bands in details), **meta)


def stream_to_arrays(stream: CodeStream):
    """``(ll, details, meta)``: numpy bands and the meta fields, the inverse
    of :func:`stream_from_arrays`."""

    def a(x):
        return x.detach().cpu().numpy()

    meta = {name: getattr(stream, name) for name in _META_FIELDS}
    spec = stream.spec
    meta["spec"] = {name: getattr(spec, name) for name in _SPEC_FIELDS}
    meta["spec"]["coeff_dtype"] = str(spec.coeff_dtype).removeprefix("torch.")
    return a(stream.ll), tuple(tuple(a(b) for b in bands) for bands in stream.details), meta
