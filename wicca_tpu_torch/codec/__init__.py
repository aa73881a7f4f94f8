"""The 8-bit image codec on PyTorch: Haar (lossy) and the lossless integer
lifting path, with progressive and region decode and stream interop."""

from wicca_tpu_torch.codec.pipeline import (
    CodeStream,
    compression_ratio,
    decode,
    decode_at_level,
    decode_region,
    encode,
    entropy_ratio,
    estimated_entropy_bytes,
    icon_from_stream,
)

__all__ = [
    "CodeStream",
    "compression_ratio",
    "decode",
    "decode_at_level",
    "decode_region",
    "encode",
    "entropy_ratio",
    "estimated_entropy_bytes",
    "icon_from_stream",
]
