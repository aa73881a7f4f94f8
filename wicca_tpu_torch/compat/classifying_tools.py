"""The reference module ``wicca.classifying_tools`` on the port."""

from wicca_tpu_torch.harness.processor import ClassifierProcessor  # noqa: F401
from wicca_tpu_torch.utils.env import is_jupyter, preserve_depth  # noqa: F401
from wicca_tpu_torch.utils.timing import format_proc_time  # noqa: F401
