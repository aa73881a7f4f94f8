"""The reference's namespace on the port (counterpart of
``wicca_tpu/compat``).

Code written against the reference imports like ``from wicca.wavelet_coder
import HaarCoder``; pointing those imports at ``wicca_tpu_torch.compat``
makes the same statements run on the port:

    import wicca_tpu_torch.compat as wicca
    from wicca_tpu_torch.compat.wavelet_coder import HaarCoder

Each submodule re-exports the port's implementation of the reference
module's names; the device rule of the port holds for every one of them:
numpy input goes to the card unless the caller passes ``device='cpu'``.
"""

from wicca_tpu_torch.compat import (  # noqa: F401
    classifying_tools,
    data_loader,
    normalization,
    result_manager,
    validation,
    visualization,
    wavelet_coder,
)
