"""Nothing the benchmark runs imports JAX or the JAX package ``repro``,
and the reference imports nothing of the program ``repro_torch``.
Top-level names are compared whole: ``repro_torch`` is not ``repro``."""
import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
SOURCES = sorted(p for p in HERE.rglob("*.py") if "tests" not in p.parts)
REFERENCE = sorted((HERE / "reference").rglob("*.py"))
JAX = ("jax", "jaxlib", "flax", "repro")


def imported(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value)


def top(module: str) -> str:
    return module.split(".")[0]


def test_sources_found():
    names = {p.name for p in SOURCES}
    assert {"run.py", "registry.py", "traffic.py", "transformer.py"} <= names
    assert REFERENCE


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_or_jax_package(path):
    bad = [m for m in imported(path) if top(m) in JAX]
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", REFERENCE,
                         ids=lambda p: str(p.relative_to(HERE)))
def test_reference_imports_nothing_of_the_program(path):
    bad = [m for m in imported(path) if top(m) in JAX + ("repro_torch",)]
    assert not bad, f"{path} imports {bad}"


def test_the_check_compares_whole_names(tmp_path):
    f = tmp_path / "x.py"
    f.write_text("import jax.numpy as jnp\nfrom repro.models import x\n"
                 "from repro_torch import y\nimport reprox\n"
                 "importlib.import_module('flax.linen')\n")
    assert [m for m in imported(f) if top(m) in JAX] == [
        "jax.numpy", "repro.models", "flax.linen"]


def test_run_refuses_loaded_jax_modules():
    from perfbench import run

    assert run.forbidden_modules(["torch", "repro_torch", "repro_torch.x",
                                  "reprox", "jaxtyping"]) == []
    assert run.forbidden_modules(["repro_torch", "repro.core", "jax",
                                  "flax.linen", "jaxlib"]) == [
        "flax", "jax", "jaxlib", "repro"]
