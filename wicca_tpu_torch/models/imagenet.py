"""ImageNet class metadata and prediction decoding (counterpart of
``wicca_tpu/models/imagenet.py``).

Labels come from, in order: a JSON named by ``WICCA_TPU_IMAGENET_INDEX``,
the local keras cache (``$KERAS_HOME/models/imagenet_class_index.json``),
or deterministic synthetic labels; nothing is fetched. The decoded tuples
``(wnid, class_name, score)`` are Keras's, so the comparison code takes
either.
"""

from __future__ import annotations

import functools
import json
import os
from pathlib import Path

import numpy as np

NUM_CLASSES = 1000


@functools.lru_cache(maxsize=1)
def class_index() -> dict[str, tuple[str, str]]:
    """{'0': (wnid, name), ...} for 1000 ImageNet classes."""
    candidates = [os.environ.get("WICCA_TPU_IMAGENET_INDEX")]
    keras_home = Path(os.environ.get("KERAS_HOME", Path.home() / ".keras"))
    candidates.append(keras_home / "models" / "imagenet_class_index.json")
    for cand in candidates:
        if cand and Path(cand).is_file():
            with open(cand) as f:
                raw = json.load(f)
            return {k: tuple(v) for k, v in raw.items()}
    return {str(i): (f"n{i:08d}", f"class_{i:03d}") for i in range(NUM_CLASSES)}


def decode_predictions(preds: np.ndarray, top: int = 5) -> list[list[tuple[str, str, float]]]:
    """Keras-compatible decoding: per row, top-k (wnid, name, score) tuples,
    highest score first (ties in ``np.argsort(row)[::-1]`` order)."""
    preds = np.asarray(preds)
    if preds.ndim != 2:
        raise ValueError(f"preds must be rank 2 (batch, classes); got shape {preds.shape}")
    idx = class_index()
    results = []
    for row in preds:
        top_idx = np.argsort(row)[::-1][:top]
        results.append([(*idx[str(int(i))], float(row[i])) for i in top_idx])
    return results
