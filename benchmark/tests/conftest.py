import pytest


@pytest.fixture
def card():
    """Skips a test that needs a CUDA card where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
