"""The image codec on PyTorch: Haar (lossy), the lossless integer lifting
path, the lossy float lifting path (CDF 9/7, db2, ICT) and the 9-16-bit
path, with progressive and region decode, maxshift ROI, application
metadata, the ``.wct`` container with its entropy coders, transcoding, rate
control (step search and PCRD truncation), stream interop, and the folder
pipeline (``encode_folder``/``decode_folder``, with its host routes in the
modules ``host_encode`` and ``host_decode`` and its pinned transfers in
``transfer``)."""

from wicca_tpu_torch.codec.batch import decode_folder, encode_folder
from wicca_tpu_torch.codec.container import deserialize, inspect, load, save, serialize
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
    with_metadata,
)
from wicca_tpu_torch.codec.rd import allocate as rd_allocate
from wicca_tpu_torch.codec.rd import encode_to_bpp, encode_to_psnr, plot_rd_curve, rd_curve, rd_point
from wicca_tpu_torch.codec.rd import measure as rd_measure
from wicca_tpu_torch.codec.rd import truncate as rd_truncate
from wicca_tpu_torch.codec.roi import apply_roi
from wicca_tpu_torch.codec.transcode import drop_finest_levels, transcode
from wicca_tpu_torch.codec.transfer import fetch_stream, put_stream

__all__ = [
    "CodeStream",
    "apply_roi",
    "compression_ratio",
    "decode",
    "decode_at_level",
    "decode_folder",
    "decode_region",
    "deserialize",
    "drop_finest_levels",
    "encode",
    "encode_folder",
    "encode_to_bpp",
    "encode_to_psnr",
    "entropy_ratio",
    "estimated_entropy_bytes",
    "fetch_stream",
    "icon_from_stream",
    "inspect",
    "load",
    "plot_rd_curve",
    "put_stream",
    "rd_allocate",
    "rd_curve",
    "rd_measure",
    "rd_point",
    "rd_truncate",
    "save",
    "serialize",
    "transcode",
    "with_metadata",
]
