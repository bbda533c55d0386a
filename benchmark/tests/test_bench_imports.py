"""No module the benchmark runs names JAX or the JAX package as its whole
top-level name, and the reference imports nothing of the program."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
BANNED = {"jax", "jaxlib", "flax", "osvos_tpu"}
SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


def _top_levels(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_anywhere(path):
    assert not set(_top_levels(path)) & BANNED


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_takes_nothing_of_the_program(path):
    allowed = {"__future__", "contextlib", "math", "statistics", "typing",
               "torch", "numpy", "benchmark"}
    names = set(_top_levels(path))
    assert "osvos_torch" not in names and names <= allowed
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module.startswith("benchmark"):
            assert node.module.startswith("benchmark.reference")


def test_the_name_check_is_by_whole_top_level_name():
    # the port's name begins with the JAX package's: only a whole name counts
    assert "osvos_torch".split(".")[0] not in BANNED
    assert "osvos_tpu.models".split(".")[0] in BANNED
