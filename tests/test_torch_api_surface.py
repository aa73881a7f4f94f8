"""``tests/test_api_surface.py``'s ``SURFACE`` (every name a reference user
relies on, in the native and the compat namespaces) on the port: each
module path with ``wicca_tpu`` replaced by ``wicca_tpu_torch``, each name
through the name map of ``docs/PORT.md`` where the port spells it
differently."""

import importlib
import re
from pathlib import Path

import pytest

from tests.test_api_surface import SURFACE

PORT_MD = Path(__file__).resolve().parent.parent / "docs" / "PORT.md"


def name_map() -> dict:
    """``docs/PORT.md``'s name map: JAX dotted name -> the port's."""
    section = PORT_MD.read_text().split("## Name map", 1)[1].split("\n## ", 1)[0]
    pairs = re.findall(r"^\| `(wicca_tpu\.[\w.]+)` \| `(wicca_tpu_torch\.[\w.]+)` \|$", section, re.M)
    return dict(pairs)


def port_name(module: str, name: str) -> tuple[str, str]:
    full = name_map().get(f"{module}.{name}", f"{module}.{name}".replace("wicca_tpu", "wicca_tpu_torch", 1))
    mod, _, attr = full.rpartition(".")
    return mod, attr


def test_the_name_map_is_read():
    m = name_map()
    assert m["wicca_tpu.ops.icon_pallas"] == "wicca_tpu_torch.ops.icon"
    assert m["wicca_tpu.parallel.tile_sharding"] == "wicca_tpu_torch.parallel.tile_placements"
    assert m["wicca_tpu.models.JaxClassifier"] == "wicca_tpu_torch.models.TorchClassifier"


@pytest.mark.parametrize("module_name", sorted(SURFACE))
def test_surface(module_name):
    missing = []
    for name in SURFACE[module_name]:
        mod, attr = port_name(module_name, name)
        if not hasattr(importlib.import_module(mod), attr):
            missing.append(f"{mod}.{attr}")
    assert not missing, f"{module_name}: the port misses {missing}"


def test_every_mapped_name_exists():
    for jax_name, port in name_map().items():
        mod, _, attr = port.rpartition(".")
        assert hasattr(importlib.import_module(mod), attr), (jax_name, port)
