"""Coder classes with the reference's WaveletCoder/HaarCoder API
(counterpart of ``wicca_tpu/coder.py``).

``coder.get_small_copy(image_hwc_u8, depth, border_type, border_constant)``
returns the depth-d LL icon: :class:`HaarCoder` bit-exact against the
reference contract, :class:`LiftingCoder` from any registered lifting
wavelet's LL band. Both accept cv2 BORDER_* enums or mode strings. A numpy
image runs on ``device`` (CUDA unless the caller passes ``device="cpu"``)
and comes back as numpy; a tensor runs where it lies and comes back as a
tensor.
"""

from __future__ import annotations

from abc import ABC, abstractmethod

import torch

from wicca_tpu_torch._device import as_tensor
from wicca_tpu_torch.core.lifting import dwt2_lifting, lifting_wavelets
from wicca_tpu_torch.core.pad import normalize_border_mode, pad_to_multiple
from wicca_tpu_torch.data.loader import from_planar, to_planar
from wicca_tpu_torch.data.validation import validate_image
from wicca_tpu_torch.ops.dwt_cuda import contiguous_aligned, icon


def _as_given(image, out: torch.Tensor):
    """``out`` in the kind of ``image``: a tensor for a tensor, else numpy."""
    return out if isinstance(image, torch.Tensor) else out.cpu().numpy()


class WaveletCoder(ABC):
    """Abstract image compressor based on multi-resolution analysis."""

    @abstractmethod
    def get_small_copy(self, image, transform_depth: int, border_type=1, border_constant: int = 0,
                       device=None):
        """Resize the image using a wavelet transform (HWC uint8 -> HWC uint8)."""


class HaarCoder(WaveletCoder):
    """Reference-parity Haar LL icon on the icon kernel (K1); also takes
    2-D grayscale input."""

    def get_small_copy(self, image, transform_depth, border_type=1, border_constant=0, device=None):
        validate_image(image)
        mode = normalize_border_mode(border_type)
        planar = as_tensor(to_planar(image), device)
        x = pad_to_multiple(planar, 1 << transform_depth, mode=mode, constant=border_constant)
        return _as_given(image, from_planar(icon(contiguous_aligned(x), transform_depth)))


class LiftingCoder(WaveletCoder):
    """Icon from a registered lifting wavelet's LL band (haar_int,
    legall5.3, db2, bior4.4, or a wavelet added with
    :func:`~wicca_tpu_torch.core.lifting.register_wavelet`), clipped and
    cast to uint8. Plain PyTorch, as the reference runs it on jnp."""

    def __init__(self, wavelet: str = "bior4.4"):
        if wavelet not in lifting_wavelets():
            raise ValueError(f"Unknown wavelet {wavelet!r}; have {sorted(lifting_wavelets())}")
        self.wavelet = wavelet

    def get_small_copy(self, image, transform_depth, border_type=1, border_constant=0, device=None):
        validate_image(image)
        mode = normalize_border_mode(border_type)
        planar = as_tensor(to_planar(image), device)
        pyr = dwt2_lifting(planar, transform_depth, self.wavelet, mode=mode, constant=border_constant)
        return _as_given(image, from_planar(torch.clamp(pyr.ll, 0, 255).to(torch.uint8)))
