"""Paper Fig. 5: utilization vs task time, measured + both model forms
(approximate U_c ~ 1/(1+t_s/t) and exact U_c^-1 = 1 + t_s n^a / (t n)).

``--P N`` renders the same view at a scaled processor count from the
committed streamed-grid artifact (``table9_tasksets --P N --grid``), where the
short-task utilization collapse the paper measures at P=1408 reappears at
100k slots with a much larger t_s.

    PYTHONPATH=src python -m repro_torch.bench.fig5_utilization [--P N]
"""
import argparse

import numpy as np

from repro_torch.bench.common import (SCHEDULERS, all_results,
                                      load_grid_artifact)
from repro_torch.core import (fit_power_law, utilization_approx,
                              utilization_constant)


def run(quiet: bool = False):
    results = all_results(multilevel=False)
    print("# Fig 5 reproduction: utilization vs task time")
    print("scheduler,t_s_task,n,measured_U,approx_model_U,exact_model_U")
    out = {}
    for fam in SCHEDULERS:
        rows = [r for r in results if r["family"] == fam]
        by_n = {}
        for r in rows:
            by_n.setdefault((r["t"], r["n"]), []).append(r["utilization"])
        # fit on this scheduler's own data
        ns = sorted({n for _, n in by_n})
        dts = []
        for n in ns:
            d = [rr["delta_t"] for rr in rows if rr["n"] == n]
            dts.append(float(np.mean(d)))
        fit = fit_power_law(ns, dts)
        curve = []
        for (t, n), us in sorted(by_n.items()):
            mu = float(np.mean(us))
            ua = float(utilization_approx(t, fit.t_s))
            ue = float(utilization_constant(t, n, fit.t_s, fit.alpha_s))
            print(f"{fam},{t},{n},{mu:.4f},{ua:.4f},{ue:.4f}")
            curve.append((t, n, mu, ua, ue))
        out[fam] = curve
    # headline check: sub-10% utilization for 1-second tasks (paper claim)
    for fam in ("slurm", "grid_engine", "mesos"):
        u1 = [c[2] for c in out[fam] if c[0] == 1.0]
        if u1 and not quiet:
            print(f"# {fam}: U(t=1s) = {u1[0]:.3f}  (paper: <0.10)")
    return out


def run_scaled(processors: int, quiet: bool = False):
    """Fig-5 data at a scaled P from the committed streamed-grid artifact."""
    grid = load_grid_artifact(processors)
    print(f"# Fig 5 at scale: utilization vs task time, P={processors}")
    print("scheduler,t_s_task,n,measured_U,approx_model_U,exact_model_U")
    out = {}
    for fam, data in grid["families"].items():
        fit = data["fit"]
        curve = []
        for r in sorted(data["rows"], key=lambda r: r["t"]):
            ua = float(utilization_approx(r["t"], fit["t_s"]))
            ue = float(utilization_constant(r["t"], r["n"], fit["t_s"],
                                            fit["alpha_s"]))
            print(f"{fam},{r['t']},{r['n']},{r['utilization']:.4f},"
                  f"{ua:.4f},{ue:.4f}")
            curve.append((r["t"], r["n"], r["utilization"], ua, ue))
        out[fam] = curve
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
