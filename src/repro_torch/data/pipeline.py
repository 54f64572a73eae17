"""Deterministic, restartable data pipeline.

``SyntheticTokens`` makes a reproducible token stream with a counter PRNG
per (seed, step): skipping to any step is O(1), which makes a restart from
a checkpoint exact. It is a copy of the reference's (numpy only), and
gives the same batches bit for bit. ``TokenPipeline`` makes batches in a
background thread, pins them in host memory, and moves each to the device
with a non-blocking copy; with a mesh, each batch becomes a DTensor split
on dimension 0 over the data axes where they divide it (replicated
otherwise), as the reference shards it.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from repro_torch import resolve_device


@dataclass
class SyntheticTokens:
    """Zipf-ish synthetic LM data; deterministic per (seed, step)."""

    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    frontend_dim: int = 0        # >0: also emit stub frontend embeddings
    frontend_tokens: int = 0

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step]))
        # zipf-like marginal over vocab, shifted per step for variety
        z = rng.zipf(1.3, size=(self.global_batch, self.seq_len + 1))
        tokens = (z - 1) % self.vocab_size
        batch = {
            "tokens": tokens[:, :-1].astype(np.int32),
            "labels": tokens[:, 1:].astype(np.int32),
        }
        if self.frontend_dim:
            batch["frontend_embeds"] = rng.standard_normal(
                (self.global_batch, self.frontend_tokens, self.frontend_dim),
            ).astype(np.float32)
            mask = np.ones((self.global_batch, self.seq_len), np.float32)
            mask[:, :self.frontend_tokens] = 0.0   # no loss on frontend stub
            batch["loss_mask"] = mask
        return batch


PREFETCH = 2   # batches made ahead of the one the trainer takes


class TokenPipeline:
    """Batches of ``source`` from ``start_step`` on, made ``PREFETCH``
    ahead in a background thread and moved to ``device``.

    ``next(pipe)`` returns (step, batch of tensors on the device). Restart:
    pass ``start_step`` (from the checkpoint) and the stream resumes
    exactly where it left off. An error in the thread is raised by the
    ``next`` that would have returned its batch. ``close()`` stops and
    joins the thread.
    """

    def __init__(self, source: SyntheticTokens, device="cuda",
                 start_step: int = 0, mesh=None):
        self.source = source
        self.mesh = mesh
        self.device = resolve_device(device)
        self.step = start_step
        self._q: "queue.Queue" = queue.Queue(maxsize=PREFETCH)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _producer(self):
        step = self.step
        pin = self.device.type == "cuda"
        while not self._stop.is_set():
            try:
                batch = {k: torch.from_numpy(v)
                         for k, v in self.source.batch_at(step).items()}
                if pin:
                    batch = {k: v.pin_memory() for k, v in batch.items()}
            except Exception as e:  # noqa: BLE001 - raised by __next__
                batch = e
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.5)
                    break
                except queue.Full:
                    continue
            if isinstance(batch, Exception):
                return
            step += 1

    def __next__(self):
        step, batch = self._q.get()
        if isinstance(batch, Exception):
            raise batch
        self.step = step + 1
        batch = {k: v.to(self.device, non_blocking=True)
                 for k, v in batch.items()}
        return step, self._shard(batch) if self.mesh is not None else batch

    def _shard(self, batch):
        """Each array split on dim 0 over the data axes ("pod", "data")
        when their product divides it, else replicated."""
        from repro_torch.distributed.sharding import distribute
        from repro_torch.launch.mesh import axis_sizes

        sizes = axis_sizes(self.mesh)
        dp = tuple(a for a in ("pod", "data") if a in sizes)
        ways = int(np.prod([sizes[a] for a in dp])) if dp else 1
        return {k: distribute(v, self.mesh, (dp,) if dp and v.shape[0]
                              % ways == 0 else ())
                for k, v in batch.items()}

    def __iter__(self):
        return self

    def close(self):
        self._stop.set()
        self._thread.join()
