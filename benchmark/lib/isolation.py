"""The modules that must never load in a benchmark process: JAX and the
JAX package, compared by whole top-level names (``wicca_tpu_torch`` is
not ``wicca_tpu``)."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "wicca_tpu"})


def loaded() -> list[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & FORBIDDEN)
