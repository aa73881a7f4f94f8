"""Canonicalization of user-facing input types (counterpart of
``wicca_tpu/data/normalization.py``).

``normalize_depth`` maps ``int | tuple | list | range`` to a tuple of
strictly positive ints; ``normalize_folder`` maps ``str | Path`` to a
``Path``. Anything else raises.
"""

from __future__ import annotations

import logging
from pathlib import Path

from wicca_tpu_torch.config.aliases import Depth

log = logging.getLogger(__name__)


def _as_positive_int(value, what: str = "depth") -> int:
    # bool is an int subclass but makes no sense as a transform depth
    if isinstance(value, bool) or not isinstance(value, int):
        raise ValueError(f"each {what} needs to be an int, got {value!r}")
    if value <= 0:
        raise ValueError(f"{what} values start at 1, got {value}")
    return value


def normalize_depth(depth: Depth) -> tuple[int, ...]:
    """Canonicalize a depth spec into a tuple of positive ints.

    Accepted: a single positive ``int``, or a ``tuple``/``list``/``range``
    of them. Everything else raises ``ValueError``.
    """
    if isinstance(depth, bool):
        raise ValueError(f"cannot interpret {depth!r} as a transform depth")
    if isinstance(depth, int):
        return (_as_positive_int(depth),)
    if isinstance(depth, range):
        depth = tuple(depth)
    if not isinstance(depth, (tuple, list)):
        raise ValueError(
            f"depth spec must be an int or a tuple/list/range of ints, got {type(depth).__name__}"
        )
    return tuple(_as_positive_int(d) for d in depth)


def normalize_folder(folder: str | Path) -> Path:
    """Canonicalize a folder spec (``str`` or ``Path``) into a ``Path``."""
    if isinstance(folder, Path):
        return folder
    if isinstance(folder, str):
        return Path(folder)
    msg = f"folder spec must be str or Path, got {type(folder).__name__}"
    log.error(msg)
    raise TypeError(msg)
