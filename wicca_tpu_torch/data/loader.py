"""Host image IO and layout conversion (counterpart of
``wicca_tpu/data/loader.py``).

Host images are HWC uint8 (decode-native; uint16 for 16-bit sources through
:func:`load_image_raw`); the device path is planar ``(C, H, W)``.
``to_planar``/``from_planar`` convert, for numpy arrays and tensors alike.
Decoding reads with cv2 and, where cv2 is not installed, with PIL
(:func:`load_image`); it runs on host threads (:func:`iter_decoded`, and the
folder pipeline's pool in :mod:`wicca_tpu_torch.codec.batch`).
"""

from __future__ import annotations

import concurrent.futures
import logging
from pathlib import Path
from typing import Iterable, Iterator

import numpy as np
import torch

from wicca_tpu_torch.data.validation import validate_image
from wicca_tpu_torch.utils.timing import count, span

IMAGE_EXTENSIONS = {".jpg", ".jpeg", ".png", ".bmp", ".tif", ".tiff", ".webp"}


def load_image(file_path: str | Path) -> np.ndarray | None:
    """Decode an image to RGB (HWC uint8; HW for a grayscale source); None
    on failure. An empty path raises."""
    if not str(file_path):
        raise ValueError("refusing to load from an empty path")
    try:
        import cv2

        image = cv2.imread(str(file_path))
        validate_image(image)
        if image.ndim == 3:
            return cv2.cvtColor(image, cv2.COLOR_BGR2RGB)
        return image
    except ImportError:
        try:
            from PIL import Image

            with Image.open(file_path) as im:
                return np.asarray(im.convert("RGB"))
        except Exception as e:  # noqa: BLE001 (any unreadable file gives None)
            logging.error(f"Error loading image {file_path}: {e}")
            return None
    except Exception as e:  # noqa: BLE001 (any unreadable file gives None)
        logging.error(f"Error loading image {file_path}: {e}")
        return None


def load_image_raw(file_path: str | Path, keep_alpha: bool = False) -> np.ndarray | None:
    """Decode an image keeping its stored bit depth (HWC RGB or HW gray;
    uint16 for 16-bit PNG/TIFF): the high-bit-depth codec's input. No dtype
    coercion; ``keep_alpha`` returns RGBA for 4-channel sources instead of
    dropping the alpha plane. None on failure; an empty path raises."""
    if not str(file_path):
        raise ValueError("refusing to load from an empty path")
    try:
        import cv2

        image = cv2.imread(str(file_path), cv2.IMREAD_UNCHANGED)
        if image is None:
            raise ValueError("cv2.imread returned None")
        if image.ndim == 3 and image.shape[2] == 4 and keep_alpha:
            image = cv2.cvtColor(image, cv2.COLOR_BGRA2RGBA)
        elif image.ndim == 3 and image.shape[2] >= 3:
            image = cv2.cvtColor(image[..., :3], cv2.COLOR_BGR2RGB)  # drop alpha, BGR -> RGB
        return image
    except Exception as e:  # noqa: BLE001 (any unreadable file gives None)
        logging.error(f"Error loading image {file_path}: {e}")
        return None


def list_images(folder: str | Path) -> list[Path]:
    """The image files of a folder, sorted, filtered by extension (other
    files, such as notes, are left out)."""
    folder = Path(folder)
    return sorted(p for p in folder.iterdir() if p.suffix.lower() in IMAGE_EXTENSIONS and p.is_file())


def to_planar(image_hwc):
    """HWC (or HW) -> planar CHW."""
    if image_hwc.ndim == 2:
        return image_hwc[None]
    if isinstance(image_hwc, torch.Tensor):
        return image_hwc.movedim(-1, 0).contiguous()
    return np.ascontiguousarray(np.moveaxis(image_hwc, -1, 0))


def from_planar(image_chw):
    """Planar CHW -> HWC (squeezes a single channel to HW)."""
    if image_chw.ndim == 3 and image_chw.shape[0] == 1:
        return image_chw[0]
    if isinstance(image_chw, torch.Tensor):
        return image_chw.movedim(0, -1)
    return np.moveaxis(image_chw, 0, -1)


def _load_spanned(path: Path) -> np.ndarray | None:
    """:func:`load_image` as the span ``data.load_image`` (the file's name),
    counting the megapixels decoded."""
    with span("data.load_image", path.name):
        image = load_image(path)
        if image is not None:
            count("data.decoded_mp", image.shape[0] * image.shape[1] / 1e6)
        return image


def iter_decoded(
    paths: Iterable[str | Path],
    num_threads: int = 8,
    prefetch: int = 2,
) -> Iterator[tuple[Path, np.ndarray | None]]:
    """Yield ``(path, HWC image or None)`` in order, decoding
    ``num_threads`` wide and ``prefetch`` batches ahead of the consumer."""
    paths = [Path(p) for p in paths]
    if not paths:
        return
    with concurrent.futures.ThreadPoolExecutor(max_workers=num_threads) as pool:
        futures: dict[int, concurrent.futures.Future] = {}
        window = max(1, num_threads * max(1, prefetch))
        for i, p in enumerate(paths[:window]):
            futures[i] = pool.submit(_load_spanned, p)
        for i, p in enumerate(paths):
            nxt = i + window
            if nxt < len(paths):
                futures[nxt] = pool.submit(_load_spanned, paths[nxt])
            yield p, futures.pop(i).result()
