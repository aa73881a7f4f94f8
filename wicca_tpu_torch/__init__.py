"""wicca_tpu_torch — the PyTorch/CUDA port of wicca_tpu for NVIDIA Hopper.

This slice holds the Haar icon path and the 8-bit Haar codec path. Their
device work runs in hand-written CUDA kernels (``csrc/``), built with nvcc
at first use; every kernel has a plain PyTorch twin that the CPU runs.

Device rule: a tensor input runs where it lies; a numpy input goes to
``device="cuda"`` unless the caller passes ``device="cpu"``; with no card
and no explicit CPU device the call raises.

The package imports torch, numpy and the standard library only — never jax
and never ``wicca_tpu``.
"""

from wicca_tpu_torch.codec.pipeline import (
    CodeStream,
    compression_ratio,
    decode,
    encode,
    entropy_ratio,
    estimated_entropy_bytes,
    icon_from_stream,
)
from wicca_tpu_torch.coder import HaarCoder, WaveletCoder
from wicca_tpu_torch.core.haar import Pyramid, block_mean_ll, dwt2, haar_icon, idwt2
from wicca_tpu_torch.core.metrics import mse, psnr
from wicca_tpu_torch.core.pad import pad_to_multiple, unpad
from wicca_tpu_torch.core.quant import QuantSpec

__all__ = [
    "CodeStream",
    "HaarCoder",
    "Pyramid",
    "QuantSpec",
    "WaveletCoder",
    "block_mean_ll",
    "compression_ratio",
    "decode",
    "dwt2",
    "encode",
    "entropy_ratio",
    "estimated_entropy_bytes",
    "haar_icon",
    "icon_from_stream",
    "idwt2",
    "mse",
    "pad_to_multiple",
    "psnr",
    "unpad",
]
