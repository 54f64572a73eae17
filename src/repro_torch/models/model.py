"""Top-level model API: init, loss, forward, prefill, decode.

``build_model(cfg)`` returns a ``Model``; parameters are a nested dict of
tensors in the reference's key layout (``embed/tok_embed``,
``stack/pos00/mixer/wq``, ...), made here from a seeded ``torch.Generator``
on the target device or converted from the reference with
``repro_torch.convert.to_torch``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict

import torch

from repro_torch import dtype_of, resolve_device
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import decode_graph, transformer
from repro_torch.models.layers import (
    embed_init, embed_tokens, lm_logits, softmax_cross_entropy)
from repro_torch.obs.spans import span

FRONTEND_TOKENS = {"vision": 256, "audio": 64, "none": 0}


class _MetaGenerator(torch.Generator):
    """A CPU generator whose ``device`` is meta: ``init(device="meta")``
    makes every leaf on the meta device (shapes and dtypes, no memory), as
    the dry run needs at full size."""

    @property
    def device(self):
        return torch.device("meta")


@dataclass(frozen=True)
class Model:
    """The model of ``cfg``. ``decode_kernel`` sends each attention layer's
    decode attention in ``decode_step`` through ``ops.decode_attention``
    (the decode kernel on CUDA tensors, its plain version on CPU tensors).
    It is the model's and not a ``decode_step`` argument so that the
    engine's call keeps the signature (params, token, caches,
    cache_index). ``graphs`` holds the decode step captured as CUDA graphs
    and counts its captures and replays (``decode_graph``)."""

    cfg: ModelConfig
    decode_kernel: bool = False
    graphs: decode_graph.Graphs = field(
        default_factory=decode_graph.Graphs, init=False, compare=False,
        hash=False, repr=False)

    def init(self, seed: int = 0, device="cuda") -> Dict[str, Any]:
        """Random parameters from ``seed`` on ``device`` (not the
        reference's random numbers: convert its weights to compare); on
        ``"meta"``, their shapes and dtypes only."""
        dev = resolve_device(device)
        gen = (_MetaGenerator() if dev.type == "meta"
               else torch.Generator(device=dev)).manual_seed(seed)
        dt = dtype_of(self.cfg)
        return {"embed": embed_init(gen, self.cfg, dt),
                "stack": transformer.stack_init(gen, self.cfg, dt)}

    def init_caches(self, batch: int, max_len: int, device="cuda"):
        return transformer.init_caches(self.cfg, batch, max_len,
                                       dtype_of(self.cfg),
                                       resolve_device(device))

    def _apply(self, params, tokens, frontend_embeds=None, caches=None,
               cache_index=None, use_kernel: bool = False,
               training: bool = False):
        """(logits [B,S,padded_vocab], caches, aux) under the caller's grad
        mode."""
        cfg = self.cfg
        x = embed_tokens(params["embed"], tokens, cfg, frontend_embeds)
        B, S = tokens.shape
        if cache_index is not None and S == 1:
            if torch.is_tensor(cache_index) and cache_index.dim() == 1:
                positions = cache_index[:, None].to(torch.int32)
            else:
                positions = torch.full((B, 1), int(cache_index),
                                       dtype=torch.int32, device=tokens.device)
        else:
            positions = torch.arange(S, dtype=torch.int32,
                                     device=tokens.device)[None]
        x, caches, aux = transformer.stack_apply(
            params["stack"], x, positions, cfg, caches=caches,
            cache_index=cache_index, use_kernel=use_kernel, training=training)
        with span("model.head"):
            logits = lm_logits(params["embed"], x, cfg)
        return logits, caches, aux

    @torch.no_grad()
    def forward(self, params, tokens, frontend_embeds=None, caches=None,
                cache_index=None, use_kernel: bool = False):
        """Returns (logits [B,S,padded_vocab], caches). Caches (k/v and
        recurrent states) are written in place. ``use_kernel`` sends
        attention (a decode step's too), the sLSTM scan, the selective scan
        and prefill's MoE expert products through ``kernels.ops``."""
        logits, caches, _ = self._apply(params, tokens, frontend_embeds,
                                        caches, cache_index, use_kernel)
        return logits, caches

    def loss(self, params, batch):
        """batch: {"tokens": [B,S], "labels": [B,S], optional
        "frontend_embeds", optional "loss_mask"}. Returns (loss, {"ce",
        "aux"}), differentiable: grad mode is on, there are no caches, the
        groups are recomputed in the backward pass as ``cfg.remat`` asks,
        and every op is a plain path (the kernels are forward-only).
        Refuses a dropless MoE (DeepSeek-V3 routing), which the port
        serves only: its balancing, the selection bias's update outside
        the gradient, is not ported."""
        if self.cfg.moe.dropless:
            raise NotImplementedError(
                f"{self.cfg.name}: training a dropless MoE is not ported "
                "(no load balancing: the selection bias's update)")
        with torch.enable_grad():
            logits, _, aux = self._apply(
                params, batch["tokens"], batch.get("frontend_embeds"),
                training=True)
            ce = softmax_cross_entropy(logits, batch["labels"],
                                       batch.get("loss_mask"))
            if not torch.is_tensor(aux):     # no MoE layer
                aux = ce.new_zeros(())
            return ce + aux, {"ce": ce, "aux": aux}

    @torch.no_grad()
    def prefill(self, params, tokens, frontend_embeds=None, max_len=None,
                use_kernel: bool = False):
        """Fill fresh caches for [0, S) (k/v up to ``max_len``, or the
        recurrent states after the prompt); returns (last_logits, caches).
        Runs in the span ``model.prefill``."""
        with span("model.prefill"):
            B, S = tokens.shape
            caches = self.init_caches(B, max_len or S, tokens.device)
            logits, caches = self.forward(params, tokens, frontend_embeds,
                                          caches=caches, cache_index=0,
                                          use_kernel=use_kernel)
            return logits[:, -1], caches

    @torch.no_grad()
    def decode_step(self, params, token, caches, cache_index):
        """token: [B,1]; cache_index: an int or a [B] tensor (position to
        write). Returns (logits [B,padded_vocab], caches). With
        ``decode_kernel`` each attention layer's decode attention goes
        through ``ops.decode_attention``; everything else takes the plain
        paths, so the MoE expert products of a decode step stay
        ``torch.einsum``. On plain CUDA tensors with per-lane positions the
        step is replayed as CUDA graphs (``decode_graph``), unless
        ``cfg.decode_graph`` is off. Runs in the span ``model.decode``."""
        with span("model.decode"):
            if self.cfg.decode_graph and decode_graph.replayed(token,
                                                               cache_index):
                return decode_graph.decode(self, params, token, caches,
                                           cache_index), caches
            logits, caches = self.forward(params, token, caches=caches,
                                          cache_index=cache_index,
                                          use_kernel=self.decode_kernel)
            return logits[:, -1], caches

    def input_specs(self, shape: ShapeConfig) -> Dict[str, Any]:
        """{name: (shape, dtype)} of a train step's batch at ``shape``."""
        if shape.kind != "train":
            raise ValueError(f"input_specs of a {shape.kind!r} step")
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len
        specs = {"tokens": ((B, S), torch.int32),
                 "labels": ((B, S), torch.int32)}
        nf = FRONTEND_TOKENS.get(cfg.frontend, 0)
        if nf:
            specs["frontend_embeds"] = ((B, nf, cfg.frontend_dim),
                                        dtype_of(cfg))
            specs["loss_mask"] = ((B, S), torch.float32)
        return specs


def build_model(cfg: ModelConfig, decode_kernel: bool = False) -> Model:
    return Model(cfg, decode_kernel)
