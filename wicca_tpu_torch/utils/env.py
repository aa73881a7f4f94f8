"""Small environment helpers (counterpart of ``wicca_tpu/utils/env.py``)."""

from __future__ import annotations

import sys


def is_jupyter() -> bool:
    """True inside a Jupyter kernel."""
    return "ipykernel" in sys.modules
