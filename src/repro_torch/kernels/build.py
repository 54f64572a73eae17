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


def build_library(source: Path, name: str) -> Path:
    """Compile ``source`` for sm_90a into ``BUILD_DIR/<name>.so``.

    Skips the build when the library is newer than its source. The library
    is written under a temporary name and renamed, so a concurrent reader
    never sees a half-written file. ptxas's report (registers, shared
    memory, spills) goes to ``BUILD_DIR/<name>.ptxas.txt``.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"{name}.so"
    if out.exists() and out.stat().st_mtime >= source.stat().st_mtime:
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
    argument types in ``_bind`` and launch it in ``__call__``, adding one
    to ``launches`` for each launch.
    """

    source: Path
    name: str

    def __init__(self):
        self.launches = 0
        self._lib = None
        self._lock = threading.Lock()

    def build(self):
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(build_library(self.source, self.name)))
                self._bind(lib)
                self._lib = lib
        return self._lib

    def _bind(self, lib) -> None:
        raise NotImplementedError
