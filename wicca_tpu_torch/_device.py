"""Where a call runs.

The rule of the port:

* a tensor input runs where the tensor lies;
* a numpy input goes to ``device="cuda"`` unless the caller passes
  ``device="cpu"`` (or another device);
* with no card and no explicit CPU device the call raises — it never
  quietly runs on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch


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
    return torch.from_numpy(np.ascontiguousarray(x)).to(dev)
