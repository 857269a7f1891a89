"""Nothing of the benchmark imports jax, jaxlib, flax or the JAX package
(cusdr_tpu), and nothing of the reference, the frozen copies, the traffic,
the roofline or the metrics imports the program (cusdr_tpu_torch): each
imported module's top-level name, the part before the first dot, compared
whole."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
NEVER = {"jax", "jaxlib", "flax", "cusdr_tpu"}
NOT_THE_PROGRAM = ("reference", "frozen", "traffic", "metrics",
                   "roofline.py")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources():
    return sorted(p for p in BENCH.rglob("*.py")
                  if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not set(_imports(path)) & NEVER


@pytest.mark.parametrize(
    "path", [p for p in _sources()
             if p.relative_to(BENCH).parts[0] in NOT_THE_PROGRAM],
    ids=lambda p: str(p.relative_to(BENCH)))
def test_reference_takes_nothing_of_the_program(path):
    assert "cusdr_tpu_torch" not in set(_imports(path))


def test_names_compared_whole():
    """cusdr_tpu_torch begins with cusdr_tpu's name and is not it."""
    import sys
    from benchmark.harness.runner import forbidden_modules
    sys.modules.setdefault("cusdr_tpu_torch_fake_probe", sys)
    try:
        assert "cusdr_tpu" not in forbidden_modules()
    finally:
        del sys.modules["cusdr_tpu_torch_fake_probe"]
    sys.modules["jaxlib"] = sys
    try:
        assert forbidden_modules() == ["jaxlib"]
    finally:
        del sys.modules["jaxlib"]
