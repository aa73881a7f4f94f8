"""Small environment helpers (counterpart of ``wicca_tpu/utils/env.py``)."""

from __future__ import annotations

import functools
import sys


def is_jupyter() -> bool:
    """True inside a Jupyter kernel."""
    return "ipykernel" in sys.modules


def preserve_depth(method):
    """Save ``self.depth`` before a method that changes it during a depth
    sweep and restore it after, also when the method raises."""

    @functools.wraps(method)
    def wrapper(self, *args, **kwargs):
        saved = self.depth
        try:
            return method(self, *args, **kwargs)
        finally:
            self.depth = saved

    return wrapper
