"""Paper Fig. 6: Delta-T vs n with multilevel scheduling (LLMapReduce) —
30-100x reduction at large n vs Fig. 4.

    PYTHONPATH=src python -m repro_torch.bench.fig6_multilevel_latency
"""
import numpy as np

from repro_torch.bench.common import all_results

ML_SCHEDULERS = ("slurm", "grid_engine", "mesos")  # as in the paper's Fig. 6


def run(quiet: bool = False):
    base = all_results(multilevel=False)
    ml = all_results(multilevel=True, schedulers=ML_SCHEDULERS)
    print("# Fig 6 reproduction: multilevel Delta-T vs n (+reduction factor)")
    print("scheduler,n,delta_t_multilevel_s,delta_t_raw_s,reduction_x")
    out = {}
    for fam in ML_SCHEDULERS:
        for n in sorted({r["n"] for r in ml if r["family"] == fam}):
            dml = float(np.mean([r["delta_t"] for r in ml
                                 if r["family"] == fam and r["n"] == n]))
            raw = [r["delta_t"] for r in base
                   if r["family"] == fam and r["n"] == n]
            draw = float(np.mean(raw)) if raw else float("nan")
            red = draw / max(dml, 1e-9) if raw else float("nan")
            print(f"{fam},{n},{dml:.2f},{draw:.2f},{red:.1f}")
            out[(fam, n)] = (dml, draw, red)
    return out


if __name__ == "__main__":
    run()
