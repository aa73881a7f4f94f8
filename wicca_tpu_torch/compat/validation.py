"""The reference module ``wicca.validation`` on the port."""

from wicca_tpu_torch.data.validation import (  # noqa: F401
    validate_image,
    validate_input_folder,
    validate_output_folder,
)
