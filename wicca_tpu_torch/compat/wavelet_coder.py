"""The reference module ``wicca.wavelet_coder`` on the port (see
:mod:`wicca_tpu_torch.coder`)."""

from wicca_tpu_torch.coder import HaarCoder, LiftingCoder, WaveletCoder  # noqa: F401
