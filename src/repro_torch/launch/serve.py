"""Serving entry point: continuous-batching engine over a seeded random model.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch phi4_mini_3_8b \\
      --full --device cuda --requests 16 --lanes 8 --max-len 1024
  PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm_1_3b \\
      --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch jamba_v01_52b \\
      --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch granite_moe_1b_a400m --full --device cuda

Without ``--full`` the arch's smoke config is served. Granite-MoE 1B-A400M
serves at full width and depth on one card, every MoE prefill product in
the grouped expert GEMM. The stats end with each kernel's launches in the
run.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import build_model
from repro_torch.serving import ServeRequest, ServingEngine


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma_2b")
    ap.add_argument("--full", action="store_true",
                    help="serve the published config (default: smoke config)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--lanes", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    cfg = get_config(args.arch) if args.full else get_smoke_config(args.arch)
    params = build_model(cfg).init(args.seed, device=args.device)
    engine = ServingEngine(cfg, params, lanes=args.lanes,
                           max_len=args.max_len)
    rng = np.random.default_rng(args.seed)
    reqs = [ServeRequest(
        prompt=rng.integers(0, cfg.vocab_size, args.prompt_len).tolist(),
        max_new_tokens=args.max_new) for _ in range(args.requests)]
    stats = engine.run(reqs)
    print("== serving stats ==")
    for k, v in stats.items():
        print(f"  {k}: {v:.4f}" if isinstance(v, float) else f"  {k}: {v}")
    print(f"  (multilevel scheduling: {stats['tokens_per_dispatch']:.2f} "
          f"tasks aggregated per dispatch)")


if __name__ == "__main__":
    main()
