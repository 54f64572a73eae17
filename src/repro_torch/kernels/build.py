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
CSRC = Path(__file__).resolve().parent / "csrc"

# per thread: the device indices whose primary context bind_context has
# made (or found) current on the thread
_THREAD = threading.local()


def bind_context(index: int) -> None:
    """Make device ``index``'s primary CUDA context current on this thread
    if the thread has none.

    The TMA bodies encode their tensor maps through the driver
    (``cuTensorMapEncodeTiled``), which needs a current context. PyTorch
    binds one lazily, at a thread's first call that needs it; a new thread
    whose first CUDA work takes a cached block and launches nothing yet (a
    worker slot of ``repro_torch.rt``) has none, and the encode fails with
    CUDA_ERROR_INVALID_CONTEXT (launch error 100201). Checked once for
    each thread and device."""
    bound = getattr(_THREAD, "bound", None)
    if bound is None:
        bound = _THREAD.bound = set()
    if index in bound:
        return
    driver = ctypes.CDLL("libcuda.so.1")
    ctx = ctypes.c_void_p()
    if driver.cuCtxGetCurrent(ctypes.byref(ctx)) != 0:
        raise RuntimeError("cuCtxGetCurrent failed")
    if not ctx.value:
        dev = ctypes.c_int()
        for call, args in (("cuDeviceGet", (ctypes.byref(dev), index)),
                           ("cuDevicePrimaryCtxRetain",
                            (ctypes.byref(ctx), dev)),
                           ("cuCtxSetCurrent", (ctx,))):
            err = getattr(driver, call)(*args)
            if err != 0:
                raise RuntimeError(f"{call} failed: CUresult {err}")
    bound.add(index)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME)")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def source_files(source: Path) -> list:
    """``source`` and every header it includes with quotes, directly or
    through another header, resolved beside the including file, else in
    ``CSRC`` (as ``nvcc -I`` resolves it)."""
    seen, todo = [], [Path(source)]
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.append(path)
        for name in _INCLUDE.findall(path.read_text()):
            for header in (path.parent / name, CSRC / name):
                if header.exists():
                    todo.append(header)
                    break
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

    Headers resolve beside ``source``, then in ``CSRC`` (a patched copy
    elsewhere finds them there). Skips the build unless ``is_stale``. The
    library is written under a temporary name and renamed, so a concurrent
    reader never sees a half-written file. ptxas's report (registers,
    shared memory, spills) goes to ``BUILD_DIR/<name>.ptxas.txt``.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"{name}.so"
    if not is_stale(out, source):
        return out
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
           "-I", str(CSRC), "-o", tmp, str(source)]
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
    ``launches`` is their sum. A captured CUDA graph replays launches
    without the wrapper: ``graph_launches`` reads them from the graph's
    nodes, for the replay to add (``kernels/ops.py::count_launches``).
    """

    source: Path
    name: str

    def __init__(self):
        self._lib = None
        self._entries = None
        self._lock = threading.Lock()
        self.reset_counts()

    @property
    def launches(self) -> int:
        with self._lock:
            return sum(self.launches_by_body.values())

    def reset_counts(self) -> None:
        self.launches_by_body = {}

    def _count(self, body: str, n: int = 1) -> None:
        """Add ``n`` launches of ``body`` (fewer where ``n`` < 0); a body
        left at none is dropped."""
        # under the lock: worker threads (repro_torch.rt) launch at once
        with self._lock:
            total = self.launches_by_body.get(body, 0) + n
            if total:
                self.launches_by_body[body] = total
            else:
                self.launches_by_body.pop(body, None)

    def graph_launches(self, graph: int) -> dict:
        """{body: launches} held by ``graph``, a captured cudaGraph_t
        (``torch.cuda.CUDAGraph(keep_graph=True).raw_cuda_graph()``): its
        kernel nodes whose function is one of the library's body kernels
        (``graph_entries`` in ``csrc/graph_nodes.cuh``), as this library's
        CUDA runtime reads them (``graph_functions``). Empty where the
        library is not loaded: it has launched nothing."""
        lib = self._lib
        if lib is None:
            return {}
        entries = self._graph_entries(lib)
        n = lib.graph_functions(graph, None, 0)
        if n < 0:
            raise RuntimeError(f"{self.name}: reading the graph's nodes "
                               f"failed: CUDA error {-n}")
        funcs = (ctypes.c_void_p * n)()
        lib.graph_functions(graph, funcs, n)
        counts: dict = {}
        for func in funcs:
            body = entries.get(func)
            if body is not None:
                counts[body] = counts.get(body, 0) + 1
        return counts

    def _graph_entries(self, lib) -> dict:
        """{host address of a body kernel: its body}, bound at first use."""
        entries = self._entries
        if entries is None:
            lib.graph_entries.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                          ctypes.c_int]
            lib.graph_entries.restype = ctypes.c_int
            lib.graph_functions.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                            ctypes.c_int]
            lib.graph_functions.restype = ctypes.c_int
            n = lib.graph_entries(None, None, 0)
            funcs = (ctypes.c_void_p * n)()
            bodies = (ctypes.c_char_p * n)()
            lib.graph_entries(funcs, bodies, n)
            entries = self._entries = {
                f: b.decode() for f, b in zip(funcs, bodies)}
        return entries

    def build(self):
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(build_library(self.source, self.name)))
                self._bind(lib)
                self._lib = lib
        return self._lib

    def _bind(self, lib) -> None:
        raise NotImplementedError
