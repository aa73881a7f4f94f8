"""Plain-PyTorch numerical core: padding, quantization, Haar and lifting
transforms, color transforms, metrics."""

from wicca_tpu_torch.core.lifting import dwt2_lifting, idwt2_lifting, lifting_wavelets, register_wavelet

__all__ = ["dwt2_lifting", "idwt2_lifting", "lifting_wavelets", "register_wavelet"]
