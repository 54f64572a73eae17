"""Frozen operation and byte counts, from a configuration's sizes alone.

``cfg`` is a configuration file's ``model`` dict (the port's
``ModelConfig`` fields). Counted for attention models whose layers are
all attention with a dense or MoE SwiGLU/GeGLU/GELU feed-forward, as the
configurations here are.
"""
from __future__ import annotations

from perfbench import peaks


def head_dim(cfg: dict) -> int:
    return int(cfg.get("head_dim") or cfg["d_model"] // cfg["n_heads"])


def padded_vocab(cfg: dict) -> int:
    return -(-int(cfg["vocab_size"]) // 256) * 256


def _moe(cfg: dict) -> dict:
    m = cfg.get("moe") or {}
    return m if m.get("n_experts", 0) > 0 else {}


def _layer_is_moe(cfg: dict, i: int) -> bool:
    m = _moe(cfg)
    return bool(m) and i % m.get("every", 1) == m.get("offset", 0)


def _nmat(cfg: dict) -> int:
    return 3 if cfg.get("act", "swiglu") in ("swiglu", "geglu") else 2


def attn_params(cfg: dict) -> int:
    d, hd = cfg["d_model"], head_dim(cfg)
    return d * hd * (cfg["n_heads"] + 2 * cfg["n_kv_heads"]) + \
        cfg["n_heads"] * hd * d


def ffn_params(cfg: dict, i: int, active: bool) -> int:
    """Weights of layer ``i``'s feed-forward: every expert, or with
    ``active`` the top-k a token goes through; the router in both."""
    d = cfg["d_model"]
    if _layer_is_moe(cfg, i):
        m = _moe(cfg)
        experts = m["top_k"] if active else m["n_experts"]
        return experts * _nmat(cfg) * d * m["d_expert"] + d * m["n_experts"]
    return _nmat(cfg) * d * cfg["d_ff"]


def n_params(cfg: dict) -> int:
    """Every parameter element, as the port lays them out: the embedding
    over the padded vocabulary (and an untied head), each layer's
    attention, feed-forward and two norm scales, the final norm."""
    d = cfg["d_model"]
    emb = padded_vocab(cfg) * d * (1 if cfg.get("tie_embeddings") else 2)
    layers = sum(attn_params(cfg) + ffn_params(cfg, i, active=False) + 2 * d
                 for i in range(cfg["n_layers"]))
    return emb + layers + d


def train_flops(cfg: dict, batch: int, seq: int) -> dict:
    """Model FLOPs of one train step (frozen from the port's
    ``chip_smoke.py::train_flops``): 6 x active parameters x tokens for the
    weight matmuls, forward and backward (an MoE layer's active experts
    are its top-k, not every expert over its capacity), plus the score
    products QK^T and PV over every (query, key) pair, three times over
    for forward and backward (12 L B S^2 Hq hd, PaLM's count).
    Recomputation under remat is not counted."""
    tokens = batch * seq
    idle = 0
    for i in range(cfg["n_layers"]):
        if _layer_is_moe(cfg, i):
            m = _moe(cfg)
            idle += _nmat(cfg) * cfg["d_model"] * m["d_expert"] * (
                m["n_experts"] - m["top_k"])
    active = n_params(cfg) - idle
    dense = 6 * active * tokens
    attn = 12 * cfg["n_layers"] * batch * seq * seq * cfg["n_heads"] * \
        head_dim(cfg)
    return {"tokens": tokens, "active_params": active, "weight_flops": dense,
            "attention_flops": attn, "flops": dense + attn}


def causal_pairs(S: int, T: int) -> int:
    """(query, key) pairs a causal attention of S queries (the last S of
    T positions) needs: query i sees keys 0 .. T - S + i."""
    return S * (T - S) + S * (S + 1) // 2


def prefill_flops(cfg: dict, S: int) -> int:
    """Useful model FLOPs of one prefill of S tokens: 2 x the layers'
    active weights x S, the causal score products (4 Hq hd a pair), and
    the output head for the one position whose logits are used."""
    hd, Hq = head_dim(cfg), cfg["n_heads"]
    weights = sum(attn_params(cfg) + ffn_params(cfg, i, active=True)
                  for i in range(cfg["n_layers"]))
    attn = cfg["n_layers"] * 4 * Hq * hd * causal_pairs(S, S)
    head = 2 * cfg["d_model"] * cfg["vocab_size"]
    return 2 * weights * S + attn + head


def k1_counts(S: int, T: int, Hq: int, Hkv: int, hd: int, B: int = 1,
              elt: int = 2) -> dict:
    """One causal flash-attention launch: FLOPs (4 hd a causal pair and
    head, each pair once), bytes (q, k, v read once, o written once) and
    the least time on the card, the larger of FLOPs over the bf16 peak
    and bytes over HBM's rate."""
    flops = 4 * B * Hq * hd * causal_pairs(S, T)
    nbytes = elt * B * (2 * S * Hq * hd + 2 * T * Hkv * hd)
    bound = max(flops / peaks.BF16_FLOPS, nbytes / peaks.HBM_BYTES)
    return {"flops": flops, "bytes": nbytes, "bound_s": bound}
