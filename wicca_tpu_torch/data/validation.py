"""Image and folder validation (counterpart of
``wicca_tpu/data/validation.py``): images must be non-None, non-empty,
uint8; input folders must exist, be directories, be readable and be
non-empty; output folders are created on demand. A non-empty output folder
never blocks on interactive input (the ``overwrite`` flag decides), and an
empty input folder raises ``ValueError``."""

from __future__ import annotations

import logging
import os
from pathlib import Path

import numpy as np
import torch

log = logging.getLogger(__name__)


def _folder(folder) -> Path:
    """A folder spec (``str`` or ``Path``) as a ``Path``."""
    if isinstance(folder, (str, Path)):
        return Path(folder)
    msg = f"folder spec must be str or Path, got {type(folder).__name__}"
    log.error(msg)
    raise TypeError(msg)


def _require_readable_dir(folder: Path, role: str) -> None:
    if not folder.is_dir():
        # distinguish "missing" from "present but not a directory"
        if not folder.exists():
            msg = f"no such {role} folder: {folder}"
            log.error(msg)
            raise FileNotFoundError(msg)
        msg = f"{role} path {folder} exists but is not a directory"
        log.error(msg)
        raise NotADirectoryError(msg)
    if not os.access(folder, os.R_OK | os.X_OK):
        msg = f"cannot read {role} folder {folder} (permission denied)"
        log.error(msg)
        raise PermissionError(msg)


def validate_input_folder(folder: str | Path, ftype: str = "data") -> Path:
    """Check a folder we read from: exists, is a directory, readable,
    non-empty."""
    folder = _folder(folder)
    _require_readable_dir(folder, ftype)
    if next(folder.iterdir(), None) is None:
        raise ValueError(f"{ftype} folder {folder} contains no files")
    return folder


def validate_output_folder(folder: str | Path, ftype: str = "result", overwrite: bool = True) -> Path:
    """Check a folder we write to, creating it when absent. With
    ``overwrite=False`` a non-empty folder raises ``FileExistsError``;
    otherwise a warning is logged and existing files may be replaced."""
    folder = _folder(folder)
    if not folder.exists():
        log.info("creating %s folder %s", ftype, folder)
        folder.mkdir(parents=True, exist_ok=True)
    _require_readable_dir(folder, ftype)
    if next(folder.iterdir(), None) is not None:
        if not overwrite:
            raise FileExistsError(f"{ftype} folder {folder} already has contents; pass overwrite=True to reuse it")
        log.warning("%s folder %s already has contents; files may be replaced", ftype, folder)
    return folder


def validate_image(image) -> None:
    """Require a non-None, non-empty uint8 array (numpy or torch)."""
    if image is None:
        raise ValueError("expected an image array, got None (did loading fail?)")
    shape = tuple(getattr(image, "shape", ()))
    size = image.numel() if isinstance(image, torch.Tensor) else getattr(image, "size", 0)
    if size == 0 or (len(shape) >= 2 and min(shape[:2]) == 0):
        raise ValueError("image has zero pixels")
    if getattr(image, "dtype", None) not in (np.uint8, torch.uint8):
        raise ValueError(f"image dtype must be uint8, got {getattr(image, 'dtype', type(image))}")
