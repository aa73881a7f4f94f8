"""Where a call runs.

The rule of the port:

* a tensor input runs where the tensor lies;
* a numpy input goes to ``device="cuda"`` unless the caller passes
  ``device="cpu"`` (or another device);
* with no card and no explicit CPU device the call raises — it never
  quietly runs on the CPU.

:func:`upload` and :func:`download` hand arrays between host memory and
the device's tensors as the link's spans (``link.up``, ``link.down``) and
byte counters (:mod:`wicca_tpu_torch.utils.timing`).
"""

from __future__ import annotations

import numpy as np
import torch

from wicca_tpu_torch.utils.timing import count, span


def host_data_device(device=None) -> torch.device:
    """Where host (numpy) data goes: ``device``, CUDA when it is None."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain PyTorch path on the CPU"
        )
    return dev


def resolve_device(x, device=None) -> torch.device:
    """The device a call on ``x`` runs on (see the module docstring)."""
    if not isinstance(x, torch.Tensor):
        return host_data_device(device)
    if device is not None:
        want = torch.device(device)
        if want.type != x.device.type or want.index not in (None, x.device.index):
            raise ValueError(f"tensor lies on {x.device}, but device={device!r} was asked for")
    return x.device


def as_tensor(x, device=None) -> torch.Tensor:
    """``x`` as a tensor on its resolved device (numpy is copied over)."""
    dev = resolve_device(x, device)
    if isinstance(x, torch.Tensor):
        return x
    return upload(x, dev)


def upload(x: np.ndarray, device) -> torch.Tensor:
    """A host array as a tensor on ``device`` (one copy to a card)."""
    x = np.ascontiguousarray(x)
    with span("link.up"):
        count("link.up_bytes", x.nbytes)
        return torch.from_numpy(x).to(device)


def download(t: torch.Tensor) -> np.ndarray:
    """A tensor as a host array (one copy from a card)."""
    with span("link.down"):
        count("link.down_bytes", t.numel() * t.element_size())
        return t.cpu().numpy()
