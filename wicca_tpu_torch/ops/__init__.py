"""Hand-written CUDA kernels for Hopper, with their plain PyTorch twins.

The public single-level Haar ops are exported here, as the JAX package
exports its Pallas counterparts; the multi-level pass kernels live in
:mod:`~wicca_tpu_torch.ops.dwt_cuda` (K1-K3), :mod:`~wicca_tpu_torch.ops.dwt53_cuda`
(K6/K7) and :mod:`~wicca_tpu_torch.ops.dwt97_cuda` (K8/K9)."""

from wicca_tpu_torch.ops.dwt97_cuda import dwt97_multilevel_quant, idwt97_multilevel_dequant
from wicca_tpu_torch.ops.dwt_cuda import dwt_level_quant, icon, idwt_level_dequant

__all__ = ["dwt97_multilevel_quant", "dwt_level_quant", "icon", "idwt97_multilevel_dequant", "idwt_level_dequant"]
