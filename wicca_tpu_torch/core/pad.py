"""Bottom/right padding to a multiple of the transform unit (counterpart of
``wicca_tpu/core/pad.py``).

``torch.nn.functional.pad`` has no ``symmetric`` mode, refuses ``reflect``
and ``circular`` pads wider than the dimension, and lacks ``replicate`` for
integer tensors on some backends. So the padding here is an index gather
whose source indices are numpy's own: ``np.pad(np.arange(n), (0, d), mode)``
gives, for every mode and every pad width, the source row (or column) of
each padded position.
"""

from __future__ import annotations

import numpy as np
import torch

# Border-mode names and the numpy mode each maps to:
#   replicate   <- cv2.BORDER_REPLICATE (1)   == np.pad 'edge'
#   constant    <- cv2.BORDER_CONSTANT  (0)   == np.pad 'constant'
#   reflect     <- cv2.BORDER_REFLECT   (2)   == np.pad 'symmetric' (edge repeated)
#   reflect101  <- cv2.BORDER_REFLECT_101 (4) == np.pad 'reflect'   (edge not repeated)
#   wrap        <- cv2.BORDER_WRAP      (3)   == np.pad 'wrap'
_MODE_TO_NP = {
    "replicate": "edge",
    "constant": "constant",
    "reflect": "symmetric",
    "reflect101": "reflect",
    "wrap": "wrap",
}

_CV2_ENUM_TO_MODE = {0: "constant", 1: "replicate", 2: "reflect", 3: "wrap", 4: "reflect101"}


def normalize_border_mode(mode) -> str:
    """Accept either a string mode or a cv2 BORDER_* integer enum."""
    if isinstance(mode, str):
        if mode not in _MODE_TO_NP:
            raise ValueError(f"Unknown border mode {mode!r}; expected one of {sorted(_MODE_TO_NP)}")
        return mode
    if isinstance(mode, int):
        try:
            return _CV2_ENUM_TO_MODE[mode]
        except KeyError:
            raise ValueError(f"Unsupported cv2 border enum {mode}") from None
    raise TypeError(f"Border mode must be str or int, got {type(mode)}")


def pad_amounts(h: int, w: int, ratio: int) -> tuple[int, int]:
    """Rows/cols to add at bottom/right so (h, w) become divisible by ratio."""
    if ratio <= 0:
        raise ValueError(f"pad ratio has to be >= 1, got {ratio}")
    return (-h) % ratio, (-w) % ratio


def _source_index(n: int, extra: int, np_mode: str, device) -> torch.Tensor:
    return torch.from_numpy(np.pad(np.arange(n, dtype=np.int64), (0, extra), mode=np_mode)).to(device)


def pad_to_multiple(x: torch.Tensor, ratio: int, mode="replicate", constant=0) -> torch.Tensor:
    """Pad the trailing two axes of ``x`` bottom/right to a multiple of
    ``ratio``; a no-op (the same tensor) when already aligned."""
    mode = normalize_border_mode(mode)
    shape = x.shape
    h, w = shape[-2], shape[-1]
    dr, dc = pad_amounts(h, w, ratio)
    if dr == 0 and dc == 0:
        return x
    if mode == "constant":
        out = torch.full(x.shape[:-2] + (h + dr, w + dc), constant, dtype=x.dtype, device=x.device)
        out[..., :h, :w] = x
        return out
    np_mode = _MODE_TO_NP[mode]
    if dr:
        x = x.index_select(-2, _source_index(h, dr, np_mode, x.device))
    if dc:
        x = x.index_select(-1, _source_index(w, dc, np_mode, x.device))
    return x


def unpad(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Crop the trailing two axes back to (h, w) — inverse of pad_to_multiple;
    ``x`` itself where it has that extent."""
    return x if x.shape[-2] == h and x.shape[-1] == w else x[..., :h, :w]
