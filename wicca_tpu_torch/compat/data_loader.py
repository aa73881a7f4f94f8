"""The reference module ``wicca.data_loader`` on the port."""

from wicca_tpu_torch.data.loader import load_image  # noqa: F401
from wicca_tpu_torch.models.registry import load_models, load_single_model  # noqa: F401


def get_padded_copy(image, ratio, border_type=1, border_constant=0, device=None):
    """The HWC (or HW) image padded bottom/right to a multiple of ``ratio``
    (:func:`wicca_tpu_torch.core.pad.pad_to_multiple`), ``border_type`` a
    cv2 ``BORDER_*`` enum or a mode name.

    The device rule of the port holds: a numpy image is padded on the card
    (``device=None``) or on ``device``, and comes back as numpy; with no
    card the call raises unless ``device='cpu'``. A tensor is padded where
    it lies and comes back as a tensor."""
    import torch

    from wicca_tpu_torch._device import as_tensor
    from wicca_tpu_torch.core.pad import pad_to_multiple
    from wicca_tpu_torch.data.loader import from_planar, to_planar

    out = from_planar(pad_to_multiple(as_tensor(to_planar(image), device), ratio, border_type, border_constant))
    return out if isinstance(image, torch.Tensor) else out.cpu().numpy()
