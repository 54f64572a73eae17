"""Paper Fig. 7: utilization vs task time, regular vs multilevel — multilevel
brings all schedulers to ~90%+ for 1-second tasks.

    PYTHONPATH=src python -m repro_torch.bench.fig7_multilevel_utilization
"""
import numpy as np

from repro_torch.bench.common import all_results
from repro_torch.bench.fig6_multilevel_latency import ML_SCHEDULERS


def run(quiet: bool = False):
    base = all_results(multilevel=False)
    ml = all_results(multilevel=True, schedulers=ML_SCHEDULERS)
    print("# Fig 7 reproduction: utilization, regular vs multilevel")
    print("scheduler,t_s_task,U_regular,U_multilevel")
    out = {}
    for fam in ML_SCHEDULERS:
        for t in sorted({r["t"] for r in ml if r["family"] == fam}):
            uml = float(np.mean([r["utilization"] for r in ml
                                 if r["family"] == fam and r["t"] == t]))
            ub = [r["utilization"] for r in base
                  if r["family"] == fam and r["t"] == t]
            ubm = float(np.mean(ub)) if ub else float("nan")
            print(f"{fam},{t},{ubm:.4f},{uml:.4f}")
            out[(fam, t)] = (ubm, uml)
        u1 = out.get((fam, 1.0))
        if u1 and not quiet:
            print(f"# {fam}: multilevel U(t=1s) = {u1[1]:.3f} (paper: ~0.9)")
    return out


if __name__ == "__main__":
    run()
