"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program. Top-level module names are
compared whole: the program's name begins with the JAX package's."""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "scenerf_tpu"}
PROGRAM = "scenerf_tpu_torch"


def top_level_imports(source: str):
    """The top-level names of every absolute import in `source`."""
    names = set()
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def files():
    return sorted(BENCH.rglob("*.py"))


def test_the_walk_finds_the_harness():
    found = {str(p.relative_to(BENCH)) for p in files()}
    assert {"run.py", "control.py", "reference/model.py", "drivers/train.py"} <= found


@pytest.mark.parametrize("path", files(), ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    bad = top_level_imports(path.read_text()) & FORBIDDEN
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_reference_imports_nothing_of_the_program(path):
    assert PROGRAM not in top_level_imports(path.read_text()), path


def test_names_are_compared_whole():
    assert top_level_imports("import scenerf_tpu_torch.model") == {PROGRAM}
    assert top_level_imports("from scenerf_tpu.model import x") & FORBIDDEN == {"scenerf_tpu"}
    assert not top_level_imports("from scenerf_tpu_torch import model") & FORBIDDEN
    assert top_level_imports("from . import geometry") == set()


def test_the_process_guard_compares_whole_names(monkeypatch):
    import sys

    from benchmark.harness import device

    monkeypatch.setitem(sys.modules, "scenerf_tpu_torch_fake", object())
    assert "scenerf_tpu" not in device.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "flax.core", object())
    assert "flax" in device.loaded_forbidden()
