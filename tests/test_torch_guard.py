"""The port and its chip smoke script import neither JAX nor the JAX package."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def test_port_has_sources():
    assert len(PORT_FILES) >= 10
    for name in ("flash_attention", "slstm_scan", "ssm_scan", "expert_gemm"):
        assert (ROOT / f"src/repro_torch/kernels/csrc/{name}.cu").exists()


@pytest.mark.parametrize(
    "path", PORT_FILES + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path} imports {bad}"


def test_guard_catches_forbidden_imports(tmp_path):
    f = tmp_path / "x.py"
    f.write_text("import jax.numpy as jnp\nfrom repro.models import x\n"
                 "from repro_torch import y\nimport repro\n")
    assert [m for m in _imported_modules(f) if _forbidden(m)] == [
        "jax.numpy", "repro.models", "repro"]


def test_chip_smoke_fails_without_a_card():
    """No CUDA: a nonzero exit and no result line."""
    torch = pytest.importorskip("torch")
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
