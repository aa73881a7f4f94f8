"""Plain-PyTorch numerical core: padding, quantization, Haar and lifting
transforms, color transforms, metrics."""

from wicca_tpu_torch.core.haar import Pyramid, dwt2, dwt2_level, haar_icon, idwt2, idwt2_level
from wicca_tpu_torch.core.lifting import dwt2_lifting, idwt2_lifting, lifting_wavelets, register_wavelet
from wicca_tpu_torch.core.metrics import ms_ssim, mse, psnr, ssim
from wicca_tpu_torch.core.pad import pad_to_multiple, unpad
from wicca_tpu_torch.core.quant import QuantSpec, dequantize_pyramid, quantize_pyramid

__all__ = [
    "Pyramid", "dwt2", "dwt2_level", "haar_icon", "idwt2", "idwt2_level",
    "dwt2_lifting", "idwt2_lifting", "lifting_wavelets", "register_wavelet",
    "mse", "psnr", "ssim", "ms_ssim", "pad_to_multiple", "unpad",
    "QuantSpec", "dequantize_pyramid", "quantize_pyramid",
]
