"""Hand-written CUDA kernels for Hopper, with their plain PyTorch twins."""

from wicca_tpu_torch.ops.dwt_cuda import dwt_level_quant, icon, idwt_level_dequant

__all__ = ["dwt_level_quant", "icon", "idwt_level_dequant"]
