from wicca_tpu_torch.config import aliases, constants  # noqa: F401
