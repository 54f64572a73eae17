"""Paper Table 10: fit Delta-T = t_s * n^alpha_s per scheduler and compare
against the paper's measured parameters.

    PYTHONPATH=src python -m repro_torch.bench.table10_model_fit
"""
import numpy as np

from repro_torch.bench.common import SCHEDULERS, all_results
from repro_torch.core import FAMILIES, fit_power_law


def run(quiet: bool = False):
    results = all_results(multilevel=False)
    print("# Table 10 reproduction: fitted (t_s, alpha_s) vs paper")
    print("scheduler,fit_ts_s,fit_alpha,r2,paper_ts_s,paper_alpha,"
          "ts_ratio,alpha_err")
    fits = {}
    for fam in SCHEDULERS:
        rows = [r for r in results if r["family"] == fam]
        by_n = {}
        for r in rows:
            by_n.setdefault(r["n"], []).append(r["delta_t"])
        ns = sorted(by_n)
        dts = [float(np.mean(by_n[n])) for n in ns]
        fit = fit_power_law(ns, dts)
        prof = FAMILIES[fam]
        fits[fam] = fit
        print(f"{fam},{fit.t_s:.2f},{fit.alpha_s:.2f},{fit.r2:.4f},"
              f"{prof.target_ts},{prof.target_alpha},"
              f"{fit.t_s / prof.target_ts:.2f},"
              f"{fit.alpha_s - prof.target_alpha:+.2f}")
    return fits


if __name__ == "__main__":
    run()
