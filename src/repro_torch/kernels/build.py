"""Build and load the port's CUDA kernels.

Each kernel is one CUDA C++ source under ``csrc/`` with a plain C
interface. At first use ``build_library`` compiles it with ``nvcc`` for
``sm_90a`` into ``build/kernels/`` at the checkout's root, and
``KernelLibrary.build`` loads it with ``ctypes``. Nothing is built when a
module is imported.
"""
from __future__ import annotations

import ctypes
import os
import re
import subprocess
import tempfile
import threading
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME)")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def source_files(source: Path) -> list:
    """``source`` and every header it includes with quotes, directly or
    through another header, resolved beside the including file."""
    seen, todo = [], [Path(source)]
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.append(path)
        for name in _INCLUDE.findall(path.read_text()):
            header = path.parent / name
            if header.exists():
                todo.append(header)
    return seen


def is_stale(out: Path, source: Path) -> bool:
    """Whether the library ``out`` is missing or older than ``source`` or
    any header it includes."""
    if not out.exists():
        return True
    built = out.stat().st_mtime
    return any(p.stat().st_mtime > built for p in source_files(source))


def build_library(source: Path, name: str) -> Path:
    """Compile ``source`` for sm_90a into ``BUILD_DIR/<name>.so``.

    Skips the build unless ``is_stale``. The library is written under a
    temporary name and renamed, so a concurrent reader never sees a
    half-written file. ptxas's report (registers, shared memory, spills)
    goes to ``BUILD_DIR/<name>.ptxas.txt``.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"{name}.so"
    if not is_stale(out, source):
        return out
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
           "-o", tmp, str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    (BUILD_DIR / f"{name}.ptxas.txt").write_text(proc.stderr)
    os.replace(tmp, out)
    return out


class KernelLibrary:
    """A kernel's library, built and loaded at first use.

    Subclasses set ``source`` and ``name``, declare the C function's
    argument types in ``_bind`` and launch it in ``__call__``, calling
    ``_count(body)`` once for each launch: ``launches_by_body`` counts
    them by the body (the kernel function of the source) that ran,
    ``launches`` is their sum.
    """

    source: Path
    name: str

    def __init__(self):
        self._lib = None
        self._lock = threading.Lock()
        self.reset_counts()

    @property
    def launches(self) -> int:
        return sum(self.launches_by_body.values())

    def reset_counts(self) -> None:
        self.launches_by_body = {}

    def _count(self, body: str) -> None:
        self.launches_by_body[body] = self.launches_by_body.get(body, 0) + 1

    def build(self):
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(build_library(self.source, self.name)))
                self._bind(lib)
                self._lib = lib
        return self._lib

    def _bind(self, lib) -> None:
        raise NotImplementedError
