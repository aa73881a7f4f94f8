"""Plain-PyTorch numerical core: padding, quantization, Haar transform, metrics."""
