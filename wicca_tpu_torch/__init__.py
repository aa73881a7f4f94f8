"""wicca_tpu_torch — the PyTorch/CUDA port of wicca_tpu for NVIDIA Hopper.

So far it holds the Haar icon path, the 8-bit Haar codec, the lossless
8-bit codec (LeGall 5/3 and integer Haar lifting, the reversible color
transform), the lossy float codec (CDF 9/7 and db2 lifting, the
irreversible color transform), the whole-image lifting path of registered
wavelets and of 9-16-bit samples, progressive and region decode, the
lifting transforms and the single-level Haar ops; and around the codec,
maxshift ROI coding, application metadata, the ``.wct`` container with its
entropy coders (``native/``, host C++ built with g++ at first use),
transcoding, SSIM/MS-SSIM and rate control, and the folder pipeline
(``encode_folder``/``decode_folder``: image IO, host-or-device routing by a
measured cost model, the host encode and decode routes on host C++, pinned
transfers and a strip-parallel PNG writer) (:mod:`wicca_tpu_torch.codec`);
and the classification harness with its model zoo
(:mod:`wicca_tpu_torch.harness`, :mod:`wicca_tpu_torch.models`: source
images against their icons or codec reconstructions through CNN and ViT
classifiers, into the reference's result CSVs). The wavelet work runs in
hand-written CUDA kernels (``csrc/``, K1-K9), built with nvcc at first use;
every kernel has a plain PyTorch twin that the CPU runs. The classifiers'
convolutions and matmuls are PyTorch's, as the JAX package leaves them to
XLA.

Device rule: a tensor input runs where it lies; a numpy input goes to
``device="cuda"`` unless the caller passes ``device="cpu"``; with no card
and no explicit CPU device the call raises.

The package imports torch, numpy and the standard library only — never jax
and never ``wicca_tpu``.
"""

from wicca_tpu_torch.codec.batch import decode_folder, encode_folder
from wicca_tpu_torch.codec.host_decode import host_decode
from wicca_tpu_torch.codec.host_encode import host_encode
from wicca_tpu_torch.codec.pipeline import (
    CodeStream,
    compression_ratio,
    decode,
    decode_at_level,
    decode_region,
    encode,
    entropy_ratio,
    estimated_entropy_bytes,
    icon_from_stream,
    with_metadata,
)
from wicca_tpu_torch.coder import HaarCoder, LiftingCoder, WaveletCoder
from wicca_tpu_torch.core.haar import Pyramid, block_mean_ll, dwt2, haar_icon, idwt2
from wicca_tpu_torch.core.lifting import dwt2_lifting, idwt2_lifting, lifting_wavelets, register_wavelet
from wicca_tpu_torch.core.metrics import ms_ssim, mse, psnr, ssim
from wicca_tpu_torch.core.pad import pad_to_multiple, unpad
from wicca_tpu_torch.core.quant import QuantSpec

__all__ = [
    "CodeStream",
    "HaarCoder",
    "LiftingCoder",
    "Pyramid",
    "QuantSpec",
    "WaveletCoder",
    "block_mean_ll",
    "compression_ratio",
    "decode",
    "decode_at_level",
    "decode_folder",
    "decode_region",
    "dwt2",
    "dwt2_lifting",
    "encode",
    "encode_folder",
    "entropy_ratio",
    "estimated_entropy_bytes",
    "haar_icon",
    "host_decode",
    "host_encode",
    "icon_from_stream",
    "idwt2",
    "idwt2_lifting",
    "lifting_wavelets",
    "ms_ssim",
    "mse",
    "pad_to_multiple",
    "psnr",
    "register_wavelet",
    "ssim",
    "unpad",
    "with_metadata",
]
