"""Layout conversion between host HWC images and the planar ``(C, H, W)``
layout of the device path (counterpart of ``wicca_tpu/data/loader.py``:
``to_planar`` / ``from_planar`` only). Both accept numpy arrays and
tensors and return the same kind."""

from __future__ import annotations

import numpy as np
import torch


def to_planar(image_hwc):
    """HWC (or HW) -> planar CHW."""
    if image_hwc.ndim == 2:
        return image_hwc[None]
    if isinstance(image_hwc, torch.Tensor):
        return image_hwc.movedim(-1, 0).contiguous()
    return np.ascontiguousarray(np.moveaxis(image_hwc, -1, 0))


def from_planar(image_chw):
    """Planar CHW -> HWC (squeezes a single channel to HW)."""
    if image_chw.ndim == 3 and image_chw.shape[0] == 1:
        return image_chw[0]
    if isinstance(image_chw, torch.Tensor):
        return image_chw.movedim(0, -1)
    return np.moveaxis(image_chw, 0, -1)
