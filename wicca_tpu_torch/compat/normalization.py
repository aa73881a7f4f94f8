"""The reference module ``wicca.normalization`` on the port."""

from wicca_tpu_torch.data.normalization import normalize_depth, normalize_folder  # noqa: F401
