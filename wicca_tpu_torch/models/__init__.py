from wicca_tpu_torch.models.registry import (
    TorchClassifier,
    available_architectures,
    load_models,
    load_single_model,
    register_architecture,
)
