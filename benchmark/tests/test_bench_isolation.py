"""Nothing the benchmark runs imports JAX or the JAX package (top-level
names compared whole: ``wicca_tpu_torch`` is not ``wicca_tpu``), and the
references import nothing of the program."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "wicca_tpu"}


def imported(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_takes_nothing_of_the_program(path):
    assert imported(path) <= {"__future__", "contextlib", "dataclasses", "math", "torch"}


def test_forbidden_names_are_whole():
    from benchmark.lib import isolation

    assert isolation.FORBIDDEN == FORBIDDEN
    assert "wicca_tpu_torch".split(".")[0] not in isolation.FORBIDDEN
