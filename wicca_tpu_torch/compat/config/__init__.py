from wicca_tpu_torch.compat.config import aliases, constants  # noqa: F401
