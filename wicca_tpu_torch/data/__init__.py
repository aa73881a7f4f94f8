"""Host-side image IO, validation and layout conversion, with the
reference's ``data_loader`` names. The model loaders are the port's
registry's, imported on first access so that the codec path, which imports
this package, does not load the model zoo."""

from wicca_tpu_torch.data.loader import from_planar, iter_decoded, list_images, load_image, to_planar  # noqa: F401
from wicca_tpu_torch.data.normalization import normalize_depth, normalize_folder  # noqa: F401
from wicca_tpu_torch.data.validation import (  # noqa: F401
    validate_image,
    validate_input_folder,
    validate_output_folder,
)

_FROM_REGISTRY = ("load_models", "load_single_model")


def __getattr__(name):
    if name in _FROM_REGISTRY:
        from wicca_tpu_torch.models import registry

        return getattr(registry, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_FROM_REGISTRY))
