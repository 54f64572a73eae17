"""Paper Fig. 4: Delta-T vs n (tasks per processor), log-log, per scheduler,
with the fitted power-law overlay.

``--P N`` renders the same figure data at a scaled processor count from the
committed streamed-grid artifact (``experiments/table9_grid_P{N}.json``,
which ``table9_tasksets --P N --grid`` reproduces field for field but
``wall_s``) — the Figure-4-style latency-scaling view of the 100k-slot
regime.

    PYTHONPATH=src python -m repro_torch.bench.fig4_latency_scaling [--P N]
"""
import argparse

import numpy as np

from repro_torch.bench.common import (SCHEDULERS, all_results,
                                      load_grid_artifact)
from repro_torch.core import fit_power_law


def run(quiet: bool = False):
    results = all_results(multilevel=False)
    print("# Fig 4 reproduction: Delta-T vs n per scheduler (log-log data)")
    print("scheduler,n,delta_t_mean_s,delta_t_min_s,delta_t_max_s,model_fit_s")
    out = {}
    for fam in SCHEDULERS:
        rows = [r for r in results if r["family"] == fam]
        by_n = {}
        for r in rows:
            by_n.setdefault(r["n"], []).append(r["delta_t"])
        ns = sorted(by_n)
        dts = [float(np.mean(by_n[n])) for n in ns]
        fit = fit_power_law(ns, dts)
        for n in ns:
            vals = by_n[n]
            print(f"{fam},{n},{np.mean(vals):.2f},{min(vals):.2f},"
                  f"{max(vals):.2f},{fit.t_s * n ** fit.alpha_s:.2f}")
        out[fam] = (ns, dts, fit)
    return out


def run_scaled(processors: int, quiet: bool = False):
    """Fig-4 data at a scaled P, from the committed streamed-grid artifact."""
    grid = load_grid_artifact(processors)
    print(f"# Fig 4 at scale: Delta-T vs n, P={processors} "
          f"(streamed, wave={grid['stream']['wave_tasks']})")
    print("scheduler,n,delta_t_s,model_fit_s,t_s,alpha_s,r2")
    out = {}
    for fam, data in grid["families"].items():
        fit = data["fit"]
        rows = sorted(data["rows"], key=lambda r: r["n"])
        for r in rows:
            model = fit["t_s"] * r["n"] ** fit["alpha_s"]
            print(f"{fam},{r['n']},{r['delta_t']:.2f},{model:.2f},"
                  f"{fit['t_s']:.3g},{fit['alpha_s']:.3g},{fit['r2']:.4f}")
        out[fam] = ([r["n"] for r in rows], [r["delta_t"] for r in rows], fit)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--P", type=int, default=None,
                    help="render from the scaled streamed-grid artifact")
    args = ap.parse_args()
    if args.P:
        run_scaled(args.P)
    else:
        run()
