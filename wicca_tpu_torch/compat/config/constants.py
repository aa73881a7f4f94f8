"""The reference module ``wicca.config.constants`` on the port."""

from wicca_tpu_torch.config.constants import *  # noqa: F401,F403
