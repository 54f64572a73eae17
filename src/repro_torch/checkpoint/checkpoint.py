"""Checkpoints with manifests, integrity digests and async writes.

The reference's on-disk layout, so a step written by either package loads
into the other (one directory per step):

  <dir>/step_000123/
    MANIFEST.json   shapes, dtypes, a blake2b-16 digest of each leaf's raw
                    bytes, the step and the caller's extra metadata
    leaf_00000.npy  one file per leaf, leaves in ``jax.tree_util``'s order
                    (``repro_torch.tree``: dict keys sorted, ``OptState``
                    as step, m, v)
    COMMIT          written last; a step without it is ignored, so a
                    restart picks the newest committed step

numpy's ``.npy`` has no bfloat16: a bfloat16 leaf is stored as its uint16
bit pattern with dtype ``bfloat16`` in the manifest, as the reference
stores it. The port goes through ``int16`` views of the tensor, so it
needs no ``ml_dtypes``.

Leaves are written, and read back and verified, by a pool of threads:
hashing and file I/O release the interpreter lock, and the digests cost
more than the writes.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as tree_lib


def _leaf_id(i: int) -> str:
    return f"leaf_{i:05d}.npy"


# threads that write or read leaves at once (each holds one leaf in flight)
IO_THREADS = min(8, os.cpu_count() or 1)


def _digest(arr: np.ndarray) -> str:
    """blake2b-16 of the array's raw bytes in C order."""
    return hashlib.blake2b(np.ascontiguousarray(arr).data,
                           digest_size=16).hexdigest()


def _to_host(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """(array to store, dtype name for the manifest)."""
    t = t.detach().to("cpu", copy=True)   # a snapshot, even of a CPU leaf
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return t.numpy(), str(t.dtype).split(".")[1]


def _to_tensor(arr: np.ndarray, dtype_str: str) -> torch.Tensor:
    if dtype_str == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr.astype(np.dtype(dtype_str), copy=False))


def _write(directory: str, step: int, host: List[Tuple[np.ndarray, str]],
           extra: Optional[Dict]) -> str:
    ckpt = Path(directory) / f"step_{step:08d}"
    tmp = Path(tempfile.mkdtemp(dir=directory, prefix=".tmp_ckpt_"))

    def leaf(i: int) -> dict:
        arr, dtype_str = host[i]
        np.save(tmp / _leaf_id(i), arr, allow_pickle=False)
        return {"file": _leaf_id(i), "shape": list(arr.shape),
                "dtype": dtype_str, "digest": _digest(arr)}

    with ThreadPoolExecutor(IO_THREADS) as pool:
        leaves = list(pool.map(leaf, range(len(host))))
    manifest = {"step": step, "treedef": "repro_torch.tree",
                "n_leaves": len(host), "leaves": leaves, "extra": extra or {}}
    (tmp / "MANIFEST.json").write_text(json.dumps(manifest, indent=1))
    (tmp / "COMMIT").write_text("ok")
    if ckpt.exists():
        shutil.rmtree(ckpt)
    os.replace(tmp, ckpt)
    return str(ckpt)


def save_checkpoint(directory: str, step: int, tree: Any,
                    extra: Optional[Dict] = None) -> str:
    """Synchronous checkpoint write. Returns the checkpoint path."""
    return _write(directory, step, [_to_host(x) for x in
                                    tree_lib.leaves(tree)], extra)


def _committed(directory: str) -> List[Path]:
    return sorted(p for p in Path(directory).glob("step_*")
                  if (p / "COMMIT").exists())


def load_checkpoint(directory: str, tree_like: Any,
                    step: Optional[int] = None,
                    verify: bool = True) -> Tuple[Any, Dict]:
    """Restore the newest committed checkpoint (or ``step``).

    ``tree_like`` is a tree of tensors. Each stored leaf must have its
    tensor's shape and dtype and is copied into it in place, on its
    device, so a restore holds no second copy of the state on the card.
    Returns (tree_like, manifest's extra)."""
    if step is not None:
        ckpt = Path(directory) / f"step_{step:08d}"
    else:
        cands = _committed(directory)
        if not cands:
            raise FileNotFoundError(f"no committed checkpoint in {directory}")
        ckpt = cands[-1]
    manifest = json.loads((ckpt / "MANIFEST.json").read_text())
    targets = tree_lib.leaves(tree_like)
    if len(targets) != manifest["n_leaves"]:
        raise ValueError(f"checkpoint has {manifest['n_leaves']} leaves, "
                         f"model expects {len(targets)}")

    def leaf(meta: dict, target: torch.Tensor) -> None:
        arr = np.load(ckpt / meta["file"], allow_pickle=False)
        if verify and _digest(arr) != meta["digest"]:
            raise IOError(f"integrity check failed for {meta['file']}")
        t = _to_tensor(arr, meta["dtype"])
        if tuple(target.shape) != tuple(t.shape) or target.dtype != t.dtype:
            raise ValueError(
                f"{meta['file']}: stored {tuple(t.shape)} {t.dtype}, "
                f"expected {tuple(target.shape)} {target.dtype}")
        with torch.no_grad():
            target.copy_(t)

    with ThreadPoolExecutor(IO_THREADS) as pool:
        for done in [pool.submit(leaf, meta, target) for meta, target
                     in zip(manifest["leaves"], targets)]:
            done.result()
    return tree_like, manifest["extra"]


def latest_step(directory: str) -> Optional[int]:
    cands = _committed(directory)
    if not cands:
        return None
    return int(cands[-1].name.split("_")[1])


class CheckpointManager:
    """Checkpointing with retention. ``save`` copies the tree to the host
    before it returns (a consistent snapshot; the next step may then change
    the state in place). With ``async_write`` it writes the files in a
    background thread, and ``wait`` joins it and raises its error, if any;
    without, ``save`` writes them itself and raises a write error at once.
    The newest ``keep`` committed steps are kept."""

    def __init__(self, directory: str, keep: int = 3,
                 async_write: bool = True):
        self.directory = directory
        Path(directory).mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_write = async_write
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, tree: Any, extra: Optional[Dict] = None) -> None:
        self.wait()
        host = [_to_host(x) for x in tree_lib.leaves(tree)]

        def write():
            _write(self.directory, step, host, extra)
            self._gc()

        if not self.async_write:
            write()
            return

        def background():
            try:
                write()
            except Exception as e:  # noqa: BLE001 - raised by wait()
                self._error = e

        self._thread = threading.Thread(target=background, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error:
            err, self._error = self._error, None
            raise err

    def restore(self, tree_like: Any, step: Optional[int] = None):
        self.wait()
        return load_checkpoint(self.directory, tree_like, step)

    def latest_step(self) -> Optional[int]:
        return latest_step(self.directory)

    def _gc(self) -> None:
        for p in _committed(self.directory)[:-self.keep]:
            shutil.rmtree(p, ignore_errors=True)
