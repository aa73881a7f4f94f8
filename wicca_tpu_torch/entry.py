"""The flagship forward (counterpart of ``__graft_entry__.entry()``): a
planar uint8 batch -> its depth-2 Haar icon (the reference's block-mean LL
chain) -> bilinear resize to 224x224 -> [-1, 1] -> MobileNetV2 logits
(width 1.0, bf16, 1000 classes).

    forward, (model, images) = entry()
    logits = forward(model, images)   # (2, 1000) float32

The model's weights come from ``nets.init_weights`` with a
``torch.Generator`` seeded 0 (the values differ from the JAX entry's
``jax.random.PRNGKey(0)`` init). It runs on CUDA unless the caller passes
``device='cpu'``; with no card and no explicit CPU device it raises.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from wicca_tpu_torch._device import as_tensor, host_data_device
from wicca_tpu_torch.core.haar import block_mean_ll
from wicca_tpu_torch.core.pad import pad_to_multiple
from wicca_tpu_torch.models import nets

INPUT = (224, 224)


def preprocess(images_u8: torch.Tensor) -> torch.Tensor:
    """(B, 3, H, W) uint8 -> the model's (B, 3, 224, 224) float32 input:
    pad to a multiple of 4, the depth-2 block-mean LL, a bilinear resize
    with half-pixel centres (``jax.image.resize(..., 'bilinear')`` on this
    upsample), then ``/127.5 - 1``."""
    icon = block_mean_ll(pad_to_multiple(images_u8, 4).to(torch.float32), 2)
    icon = F.interpolate(icon, size=INPUT, mode="bilinear", align_corners=False, antialias=False)
    return icon / 127.5 - 1.0


def entry(device=None):
    """``(forward, (model, example_images))``: ``forward(model, images_u8)``
    runs :func:`preprocess` and the model on the model's device (numpy
    images go there) and returns float32 logits."""
    dev = host_data_device(device)
    model = nets.init_weights(nets.MobileNetV2(), torch.Generator().manual_seed(0)).eval().to(dev)

    def forward(model, images_u8):
        x = as_tensor(images_u8, next(model.parameters()).device)
        with torch.inference_mode():
            return model(preprocess(x))

    example_images = np.zeros((2, 3, 256, 256), dtype=np.uint8)
    return forward, (model, example_images)
