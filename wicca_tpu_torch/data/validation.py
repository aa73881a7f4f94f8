"""Image validation (counterpart of ``wicca_tpu/data/validation.py``:
``validate_image`` only)."""

from __future__ import annotations

import numpy as np
import torch


def validate_image(image) -> None:
    """Require a non-None, non-empty uint8 array (numpy or torch)."""
    if image is None:
        raise ValueError("expected an image array, got None (did loading fail?)")
    shape = tuple(getattr(image, "shape", ()))
    size = image.numel() if isinstance(image, torch.Tensor) else getattr(image, "size", 0)
    if size == 0 or (len(shape) >= 2 and min(shape[:2]) == 0):
        raise ValueError("image has zero pixels")
    if getattr(image, "dtype", None) not in (np.uint8, torch.uint8):
        raise ValueError(f"image dtype must be uint8, got {getattr(image, 'dtype', type(image))}")
