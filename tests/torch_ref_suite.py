"""Run the reference's own scheduler-side tests against the port.

``export(name, globals())`` reads ``tests/<name>.py``, rewrites its imports
of ``repro.core``, ``repro.workloads``, ``repro.obs`` and ``repro.rt`` to the
port's packages (and of ``reference_policies`` to
``torch_reference_policies``), serves its imports of sibling reference test
modules (``SIBLINGS``) from their port copies loaded the same way and its
imports of the reference's ``benchmarks/`` modules (``BENCHMARKS``) from the
port's drivers, drops the tests named in ``LEFT_OUT``, refuses the file if
any import of the reference package, of JAX, of another reference test
module or of ``benchmarks/`` is left, and executes the result as a module
whose ``__file__`` is the reference file, so paths such as
``Path(__file__).parent / "fixtures"`` resolve as they do there. Its tests,
fixtures and helpers are then copied into the caller's globals, where pytest
collects them with their parametrisation and hypothesis settings. Each test
body exists once: in the reference's file.
"""
from __future__ import annotations

import ast
import sys
import types
from pathlib import Path

from _pytest.assertion.rewrite import rewrite_asserts

TESTS = Path(__file__).resolve().parent

REWRITES = {
    "repro.core": "repro_torch.core",
    "repro.workloads": "repro_torch.workloads",
    "repro.obs": "repro_torch.obs",
    "repro.rt": "repro_torch.rt",
    "reference_policies": "torch_reference_policies",
}
#: reference test modules that other reference test files import; served
#: from their port copies (``torch_ref.<name>``, loaded on demand)
SIBLINGS = ("test_faultplane", "test_wavepath")
#: modules of the reference's benchmarks/ that reference test files import
#: (with benchmarks/ put on sys.path), and the port's drivers that stand in
BENCHMARKS = {"common": "repro_torch.bench.common"}
FORBIDDEN = ("repro", "jax", "jaxlib")
#: names a rewritten file may not import: the reference's test modules and
#: the modules of its benchmarks/ (the latter import the reference)
REFERENCE_TESTS = frozenset(
    p.stem for p in TESTS.glob("test_*.py")
    if not p.stem.startswith("test_torch_"))
BENCHMARK_MODULES = frozenset(
    {"benchmarks"} | {p.stem for p in (TESTS.parent / "benchmarks").glob(
        "*.py")})
PACKAGE = "torch_ref"

#: tests of a reference file that are not run against the port, each with
#: its reason
LEFT_OUT = {
    "test_properties": {
        "test_chunked_attention_equals_full_property":
            "model code, not the scheduler: it imports repro.configs and "
            "repro.models (the reference's attention); the port's model "
            "tests (tests/test_torch_layers.py, tests/test_torch_model.py) "
            "hold its chunked attention against full attention",
    },
}


def _rewrite(module: str) -> str:
    for old, new in REWRITES.items():
        if module == old or module.startswith(old + "."):
            return new + module[len(old):]
    if module in SIBLINGS:
        return f"{PACKAGE}.{module}"
    if module in BENCHMARKS:
        return BENCHMARKS[module]
    return module


def _refused(module: str) -> bool:
    top = module.split(".")[0]
    return (top in FORBIDDEN or top in REFERENCE_TESTS
            or top in BENCHMARK_MODULES)


def _imports(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node, alias
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node, None


def translate(name: str, path: Path = None) -> tuple[ast.Module, Path]:
    """The reference file ``tests/<name>.py`` (or ``path``) as a module tree
    that imports the port: left-out tests removed, imports rewritten and
    checked."""
    path = TESTS / f"{name}.py" if path is None else path
    tree = ast.parse(path.read_text(), str(path))
    drop = LEFT_OUT.get(name, {})
    kept = [n for n in tree.body
            if not (isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and n.name in drop)]
    missing = set(drop) - {n.name for n in tree.body
                           if isinstance(n, (ast.FunctionDef,
                                             ast.AsyncFunctionDef))}
    if missing:
        raise LookupError(f"{path}: LEFT_OUT names {sorted(missing)}, "
                          "which the file does not define")
    tree.body = kept
    left = []
    for node, alias in _imports(tree):
        if alias is not None:
            alias.name = _rewrite(alias.name)
            module = alias.name
        else:
            node.module = _rewrite(node.module)
            module = node.module
        if _refused(module):
            left.append(f"line {node.lineno}: {module}")
    if left:
        raise ImportError(f"{path} still imports the reference, JAX, a "
                          "reference test module or benchmarks/ after the "
                          f"rewrite: {left}; port the module or add the "
                          "test to LEFT_OUT with its reason")
    return tree, path


def _package() -> None:
    """``torch_ref``, the package the loaded copies live in."""
    if PACKAGE not in sys.modules:
        pkg = types.ModuleType(PACKAGE)
        pkg.__path__ = []
        sys.modules[PACKAGE] = pkg


def load(name: str) -> types.ModuleType:
    """Execute the translated ``tests/<name>.py`` as a module, after the
    sibling modules it imports."""
    tree, path = translate(name)
    _package()
    for node, alias in _imports(tree):
        module = alias.name if alias is not None else node.module
        sibling = module[len(PACKAGE) + 1:]
        if module.startswith(PACKAGE + ".") and \
                module not in sys.modules:
            load(sibling)
    rewrite_asserts(tree, path.read_bytes(), str(path))
    mod = types.ModuleType(f"{PACKAGE}.{name}")
    mod.__file__ = str(path)
    sys.modules[mod.__name__] = mod
    exec(compile(tree, str(path), "exec"), mod.__dict__)
    return mod


def export(name: str, into: dict) -> types.ModuleType:
    """Load ``tests/<name>.py`` against the port and copy its public names
    (tests, fixtures, helpers) into ``into``."""
    mod = load(name)
    for key, value in vars(mod).items():
        if not key.startswith(("__", "@")):
            into[key] = value
    return mod
