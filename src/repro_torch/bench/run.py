"""Benchmark runner: one function per paper table/figure + the roofline and
real-dispatch benchmarks, on the port. Prints ``name,us_per_call,derived``
CSV summary at the end after each benchmark's own detailed output.

    PYTHONPATH=src python -m repro_torch.bench.run [--device cpu]

The dispatch benchmark runs on ``--device`` (the card by default); the
roofline reads the dry run's records (``repro_torch.launch.dryrun``).
"""
from __future__ import annotations

import argparse
import time

from repro_torch.bench import (dispatch_latency, fig4_latency_scaling,
                               fig5_utilization, fig6_multilevel_latency,
                               fig7_multilevel_utilization, roofline,
                               table9_tasksets, table10_model_fit)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda",
                    help="device of the dispatch benchmark")
    args = ap.parse_args(argv)
    summary = []

    def timed(name, fn, derive):
        t0 = time.perf_counter()
        out = fn()
        dt = (time.perf_counter() - t0) * 1e6
        summary.append((name, dt, derive(out)))
        print()
        return out

    timed("table9_tasksets", table9_tasksets.run,
          lambda rows: f"runs={len(rows)}")
    timed("table10_model_fit", table10_model_fit.run,
          lambda f: ";".join(
              f"{k}:ts={v.t_s:.2f},a={v.alpha_s:.2f}"
              for k, v in f.items()))
    timed("fig4_latency_scaling", fig4_latency_scaling.run,
          lambda o: f"schedulers={len(o)}")
    timed("fig5_utilization", fig5_utilization.run,
          lambda o: "U(slurm,t=1)="
          + f"{[c[2] for c in o['slurm'] if c[0] == 1.0][0]:.3f}")
    timed("fig6_multilevel_latency", fig6_multilevel_latency.run,
          lambda o: "max_reduction="
          + f"{max(v[2] for v in o.values()):.0f}x")
    timed("fig7_multilevel_utilization", fig7_multilevel_utilization.run,
          lambda o: "U_ml(slurm,t=1)="
          + f"{o[('slurm', 1.0)][1]:.3f}")
    timed("dispatch_latency",
          lambda: dispatch_latency.run(args.device),
          lambda o: f"torch_ts_us={o[0] * 1e6:.1f}")
    timed("roofline", roofline.run,
          lambda rows: f"cells={len(rows)}")

    print("# ==== summary (name,us_per_call,derived) ====")
    for name, us, derived in summary:
        print(f"{name},{us:.0f},{derived}")
    return summary


if __name__ == "__main__":
    main()
