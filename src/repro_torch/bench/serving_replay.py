"""Serving replay: a backlog of concurrent requests through the
continuous-batching engine's admission path, tokens/s against lanes.

The trace is a seeded backlog, all requests outstanding at once; each
becomes a one-task job in the engine's lane resource manager, admitted
FIFO in trace order as lanes free up. With the backlog far larger than the
lanes this is the paper's Case 2 for the serving control plane: the cost
of a dispatch is shared by the lanes decoding in it, so tokens per
dispatch (and tokens/s) rise with the lane count until the batch stops
filling. Prompts have one length; decode lengths vary per request, which
makes admission continuous rather than lock-step.

  PYTHONPATH=src python -m repro_torch.bench.serving_replay --quick
  PYTHONPATH=src python -m repro_torch.bench.serving_replay --quick \\
      --device cpu
  PYTHONPATH=src python -m repro_torch.bench.serving_replay --full \\
      --requests 10000 --lanes 8 32 128 --out replay.json

The phi4 smoke config by default, ``--full`` for Phi-4-mini at its
published widths; weights random from seed 0. JSON is written only to
``--out``.
"""
from __future__ import annotations

import argparse
import json
import random
import time
from pathlib import Path

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels import ops
from repro_torch.models import build_model
from repro_torch.serving import ServeRequest, ServingEngine

PROMPT_LEN = 8
MAX_LEN = 64


def build_trace(n_requests: int, vocab: int, *, seed: int = 0):
    """Seeded request backlog: (prompt, max_new_tokens) pairs, submitted
    in trace order at once (the whole trace is concurrent)."""
    rng = random.Random(seed)
    return [([rng.randrange(vocab) for _ in range(PROMPT_LEN)],
             rng.randint(2, 6))
            for _ in range(n_requests)]


def replay(trace, cfg, params, lanes: int) -> dict:
    """One replay of ``trace`` at ``lanes``, after a warm-up request."""
    eng = ServingEngine(cfg, params, lanes=lanes, max_len=MAX_LEN)
    reqs = [ServeRequest(prompt=p, max_new_tokens=m) for p, m in trace]
    # warm both step shapes outside the measured window; the engine's
    # step and token counters are cumulative, so zero them after
    warm = ServeRequest(prompt=list(trace[0][0]), max_new_tokens=2)
    eng.run([warm])
    eng.steps = 0
    eng.decode_tokens = 0
    w0 = time.time()
    stats = eng.run(reqs)
    wall = time.time() - w0
    return {
        "lanes": lanes,
        "requests": stats["requests"],
        "decode_steps": stats["decode_steps"],
        "decode_tokens": stats["decode_tokens"],
        "tokens_per_dispatch": round(stats["tokens_per_dispatch"], 2),
        "throughput_tok_s": round(stats["decode_tokens"] / max(wall, 1e-9),
                                  1),
        "mean_latency_s": round(stats["mean_latency_s"], 4),
        "p99_latency_s": round(stats["p99_latency_s"], 4),
        "wall_s": round(wall, 2),
        "launches": {name: stats[f"{name}_launches"] for name in ops.KERNELS},
    }


def smoke_invariant(rows) -> bool:
    """Batching amortises dispatches: a smoke check, not a perf gate."""
    return rows[-1]["tokens_per_dispatch"] > rows[0]["tokens_per_dispatch"] * 0.5


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--requests", type=int, default=10000)
    ap.add_argument("--lanes", type=int, nargs="+", default=(8, 32, 128))
    ap.add_argument("--quick", action="store_true",
                    help="smoke size: 120 requests, lanes 4 and 16")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full", action="store_true",
                    help="Phi-4-mini at its published widths")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    if args.quick:
        args.requests, args.lanes = 120, (4, 16)

    cfg = (get_config if args.full else get_smoke_config)("phi4_mini_3_8b")
    params = build_model(cfg).init(0, device=args.device)
    trace = build_trace(args.requests, cfg.vocab_size)

    rows = []
    print(f"# serving replay: {args.requests} concurrent requests "
          f"(seeded backlog, prompt_len={PROMPT_LEN}, {cfg.name}, "
          f"{args.device})")
    print("lanes,requests,decode_steps,tokens_per_dispatch,"
          "throughput_tok_s,mean_latency_s,p99_latency_s,wall_s")
    for lanes in args.lanes:
        r = replay(trace, cfg, params, lanes)
        print(f"{r['lanes']},{r['requests']},{r['decode_steps']},"
              f"{r['tokens_per_dispatch']},{r['throughput_tok_s']},"
              f"{r['mean_latency_s']},{r['p99_latency_s']},{r['wall_s']}",
              flush=True)
        rows.append(r)
    if args.quick:
        if not smoke_invariant(rows):
            raise AssertionError(f"batching did not amortise dispatches: "
                                 f"{rows}")
        print("serving replay smoke OK")
    if args.out is not None:
        out = {"bench": "serving_replay", "arch": cfg.name,
               "dtype": cfg.dtype, "device": args.device,
               "requests": args.requests, "prompt_len": PROMPT_LEN,
               "max_len": MAX_LEN, "rows": rows}
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(out, indent=2) + "\n")
        print(f"-> {args.out}")
    return rows


if __name__ == "__main__":
    main()
