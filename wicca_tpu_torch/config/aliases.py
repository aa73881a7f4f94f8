"""Public-API type aliases (counterpart of ``wicca_tpu/config/aliases.py``).

The names are the reference API surface: ``ModelClass``,
``ModelWithConfig``, ``ModelsDict`` and ``Depth``; ``DepthSpec`` is the
name used internally, ``Depth`` its compat spelling.
"""

from __future__ import annotations

import os
from collections.abc import Callable
from typing import Any, TypeAlias, Union

#: Anything accepted as a transform-depth argument.  A bare ``int`` means one
#: depth; any iterable of ints (tuple/list/range) means a depth sweep.
#: Normalised to ``tuple[int, ...]`` by
#: ``wicca_tpu_torch.data.normalization.normalize_depth``.
DepthSpec: TypeAlias = Union[int, tuple[int, ...], list[int], range]

#: Compat spelling used by the reference API surface.
Depth: TypeAlias = DepthSpec

#: A zero-arg-constructible classifier factory (a zoo entry, a Keras-like
#: class, or any callable returning a model object).
ModelClass: TypeAlias = Callable

#: ``(factory, options)`` — options dict may carry ``{"shape": (h, w)}`` etc.
ModelWithConfig: TypeAlias = tuple[ModelClass, dict[str, Any]]

#: Registry input for ``wicca_tpu_torch.models.load_models``:
#: display name -> factory, or -> (factory, options).
ModelsDict: TypeAlias = dict[str, Union[ModelClass, ModelWithConfig]]

#: Filesystem locations accepted throughout the data layer.
PathLike: TypeAlias = Union[str, os.PathLike]

__all__ = [
    "Depth",
    "DepthSpec",
    "ModelClass",
    "ModelWithConfig",
    "ModelsDict",
    "PathLike",
]
