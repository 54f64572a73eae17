"""Serving example: batched requests through the continuous-batching
engine, showing the paper's multilevel-scheduling effect on a real model.

Compares (a) one request at a time (per-task dispatch, the paper's Case 2:
t <~ t_s) against (b) continuous batching over 8 lanes (aggregation): the
same outputs, far fewer dispatches, higher throughput.

  PYTHONPATH=src python -m repro_torch.examples.serve_batched            # card
  PYTHONPATH=src python -m repro_torch.examples.serve_batched --device cpu
  PYTHONPATH=src python -m repro_torch.examples.serve_batched --full \\
      --dtype float32

Without ``--full`` the gemma smoke config is served; with it, Gemma 2B at
its published widths. Weights are random from seed 0. On the card a bf16
GEMM of one row may round differently from one of eight and flip an
argmax, so identical outputs are asked of float32 runs there.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import ModelConfig
from repro_torch.models import build_model
from repro_torch.serving import ServeRequest, ServingEngine

N_REQ, PROMPT, NEW = 16, 10, 12
MAX_LEN = 64


def make_prompts(vocab: int):
    rng = np.random.default_rng(0)
    return [list(rng.integers(0, vocab, PROMPT)) for _ in range(N_REQ)]


def serve(cfg: ModelConfig, params, lanes: int, prompts):
    """(requests with their outputs, the engine's stats, wall seconds)."""
    eng = ServingEngine(cfg, params, lanes=lanes, max_len=MAX_LEN)
    reqs = [ServeRequest(prompt=p, max_new_tokens=NEW) for p in prompts]
    t0 = time.time()
    stats = eng.run(reqs)
    return reqs, stats, time.time() - t0


def compare(cfg: ModelConfig, params) -> dict:
    """Serve the example's requests on 1 lane, then on 8; raises if the
    outputs differ."""
    prompts = make_prompts(cfg.vocab_size)
    reqs1, s1, t_serial = serve(cfg, params, 1, prompts)
    reqs8, s8, t_batched = serve(cfg, params, 8, prompts)
    for a, b in zip(reqs1, reqs8):
        if a.output != b.output:
            raise AssertionError("batching must not change outputs: "
                                 f"{a.output} != {b.output}")
    return {"serial": s1, "batched": s8, "t_serial_s": t_serial,
            "t_batched_s": t_batched,
            "outputs": [r.output for r in reqs8],
            "dispatch_reduction": s1["decode_steps"] / s8["decode_steps"]}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full", action="store_true",
                    help="Gemma 2B at its published widths")
    ap.add_argument("--dtype", default=None,
                    help="override the config's dtype (e.g. float32)")
    args = ap.parse_args(argv)
    cfg = get_config("gemma_2b") if args.full else get_smoke_config(
        "gemma_2b")
    if args.dtype:
        cfg = dataclasses.replace(cfg, dtype=args.dtype)
    params = build_model(cfg).init(0, device=args.device)
    res = compare(cfg, params)
    s1, s8 = res["serial"], res["batched"]
    print(f"{N_REQ} requests x {NEW} new tokens ({cfg.name}, {cfg.dtype}, "
          f"{args.device})")
    print(f"  serial (1 lane):      {res['t_serial_s']:6.2f}s, "
          f"{s1['decode_steps']} dispatches, "
          f"{s1['throughput_tok_s']:.1f} tok/s")
    print(f"  batched (8 lanes):    {res['t_batched_s']:6.2f}s, "
          f"{s8['decode_steps']} dispatches, "
          f"{s8['throughput_tok_s']:.1f} tok/s")
    print(f"  tokens per dispatch:  {s1['tokens_per_dispatch']:.2f} -> "
          f"{s8['tokens_per_dispatch']:.2f}  (multilevel aggregation)")
    print(f"  dispatch reduction:   {res['dispatch_reduction']:.1f}x "
          f"(wall {res['t_serial_s'] / res['t_batched_s']:.2f}x)")
    print("  outputs identical: continuous batching is semantics-preserving")
    return res


if __name__ == "__main__":
    main()
