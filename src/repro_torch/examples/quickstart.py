"""Quickstart: the paper's result in a few seconds, on the port's scheduler.

1. Run a 1408-core scheduler simulation of 1-second tasks -> utilization
   collapses (paper Fig. 5).
2. Turn on multilevel scheduling (LLMapReduce aggregation) -> utilization
   >90% (paper Fig. 7).
3. Fit the latency model (t_s, alpha_s) like the paper's Table 10.

  PYTHONPATH=src python -m repro_torch.examples.quickstart

Virtual time on the host (no device work): the numbers equal the
reference's ``examples/quickstart.py`` bit for bit.
"""
from __future__ import annotations

from repro_torch.core import (FAMILIES, Job, ResourceManager, Scheduler,
                              aggregate, fit_power_law)

P = 1408          # the paper's 44-node x 32-core cluster
N_PER_PROC = 240  # Table 9 "rapid" set: 240s of 1-second tasks per core
TASK_T = 1.0
FIT_GRID = ((4, 60.0), (8, 30.0), (48, 5.0), (240, 1.0))


def run(multilevel: bool):
    """(T_total, U) of the rapid set, direct or bundled."""
    rm = ResourceManager()
    rm.add_nodes(P, slots=1)
    sched = Scheduler(rm, profile=FAMILIES["slurm"])
    job = Job.array(N_PER_PROC * P, duration=TASK_T, name="analytics")
    if multilevel:
        job = aggregate(job, slots=P)   # LLMapReduce-style bundling
    sched.submit(job)
    sched.run()
    st = sched.stats[job.job_id]
    T_total = st.last_end - st.submit_time
    T_job = TASK_T * N_PER_PROC
    return T_total, T_job / T_total


def model_fit():
    """Table-10-style fit over the paper's task-set grid: (ns, Delta-T
    values, fit)."""
    ns, dts = [], []
    for n, t in FIT_GRID:
        rm = ResourceManager()
        rm.add_nodes(P, slots=1)
        s = Scheduler(rm, profile=FAMILIES["slurm"])
        job = Job.array(n * P, duration=t)
        s.submit(job)
        s.run()
        st = s.stats[job.job_id]
        ns.append(n)
        dts.append((st.last_end - st.submit_time) - n * t)
    return ns, dts, fit_power_law(ns, dts)


def main() -> dict:
    t_raw, u_raw = run(multilevel=False)
    t_ml, u_ml = run(multilevel=True)
    print(f"84,480 one-second tasks on {P} cores (Slurm-calibrated profile)")
    print(f"  direct submission:   {t_raw:7.1f}s wall, utilization {u_raw:5.1%}")
    print(f"  multilevel (bundled): {t_ml:7.1f}s wall, utilization {u_ml:5.1%}")
    print(f"  speedup {t_raw / t_ml:.1f}x — the paper's headline result.")
    ns, dts, fit = model_fit()
    print(f"  latency model fit: {fit} (paper Slurm: t_s=2.2s, alpha=1.3)")
    return {"direct": (t_raw, u_raw), "bundled": (t_ml, u_ml),
            "fit_n": ns, "fit_dt": dts, "fit": fit}


if __name__ == "__main__":
    main()
