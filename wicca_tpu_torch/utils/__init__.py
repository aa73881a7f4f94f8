"""Small shared helpers of the port."""

from wicca_tpu_torch.utils.env import is_jupyter, preserve_depth  # noqa: F401
from wicca_tpu_torch.utils.timing import StageTimer, format_proc_time, trace  # noqa: F401
