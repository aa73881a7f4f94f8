"""The image codec on PyTorch: Haar (lossy), the lossless integer lifting
path, the lossy float lifting path (CDF 9/7, db2, ICT) and the 9-16-bit
path, with progressive and region decode and stream interop."""

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
