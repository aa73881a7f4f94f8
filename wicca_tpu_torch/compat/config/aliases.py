"""The reference module ``wicca.config.aliases`` on the port."""

from wicca_tpu_torch.config.aliases import Depth, ModelClass, ModelsDict, ModelWithConfig  # noqa: F401
