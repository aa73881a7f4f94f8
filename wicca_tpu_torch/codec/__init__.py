"""The Haar image codec on PyTorch (encode/decode and stream interop)."""

from wicca_tpu_torch.codec.pipeline import (
    CodeStream,
    compression_ratio,
    decode,
    encode,
    entropy_ratio,
    estimated_entropy_bytes,
    icon_from_stream,
)

__all__ = [
    "CodeStream",
    "compression_ratio",
    "decode",
    "encode",
    "entropy_ratio",
    "estimated_entropy_bytes",
    "icon_from_stream",
]
