"""Paper Table 9: runtimes of the four constant-time task sets on the four
schedulers (1408 cores, 3 trials) — plus scaled grids toward P >= 100k.

Default invocation runs the paper's grid (every row the committed
experiments/bench_cache.json holds must come out equal to it). ``--P`` runs
a single-family scaled grid at an arbitrary processor count and refits the
latency model (Delta-T = t_s * n^alpha_s) with
``latency_model.fit_power_law``. ``--grid`` runs the *full four-family*
Table-9 protocol at that P — all four task sets (n in {4, 8, 48, 240}),
streamed through the workload subsystem in waves of P tasks under an
active-job cap, so the n=240 set (24.6M tasks at P=102,400) never
materializes more than a few waves — and refits per family. Results are
written only to the file ``--out`` names:

    PYTHONPATH=src python -m repro_torch.bench.table9_tasksets
    PYTHONPATH=src python -m repro_torch.bench.table9_tasksets --P 102400
    PYTHONPATH=src python -m repro_torch.bench.table9_tasksets \
        --P 102400 --grid --out grid.json
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Dict, Optional

from repro_torch.bench.common import (SCHEDULERS, STREAM_ACTIVE_JOBS,
                                      TASK_SETS, all_results, run_taskset)
from repro_torch.core.latency_model import fit_power_law


def _write(out: Optional[Path], result: Dict) -> None:
    if out is not None:
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(result, indent=2) + "\n")
        print(f"-> {out}")


def run(quiet: bool = False, out: Optional[Path] = None):
    results = all_results(multilevel=False)
    rows = []
    print("# Table 9 reproduction: total runtimes (s), 3 trials")
    print("scheduler,set,t,n,trial,T_total_s,delta_t_s,utilization")
    for r in results:
        print(f"{r['family']},{r['set']},{r['t']},{r['n']},{r['trial']},"
              f"{r['T_total']:.1f},{r['delta_t']:.1f},{r['utilization']:.4f}")
        rows.append(r)
    _write(out, {"bench": "table9", "rows": rows})
    return rows


def run_scaled(processors: int, family: str = "slurm",
               n_values=(1, 2, 4, 8), t: float = 1.0, fit: bool = True,
               out: Optional[Path] = None):
    """The Table-9 protocol at P processors: one constant-time set per n,
    then a power-law refit of (t_s, alpha_s) from the measured Delta-T."""
    print(f"# Table 9 scaled grid: P={processors}, family={family}, t={t}s")
    print("scheduler,P,t,n,T_total_s,delta_t_s,utilization")
    rows = []
    for n in n_values:
        r = run_taskset(family, n, t, processors=processors)
        print(f"{family},{processors},{t},{n},{r['T_total']:.1f},"
              f"{r['delta_t']:.2f},{r['utilization']:.4f}")
        rows.append(r)
    result = {"bench": "table9_scaled", "P": processors, "family": family,
              "t": t, "rows": rows}
    if fit:
        model = fit_power_law([r["n"] for r in rows],
                              [r["delta_t"] for r in rows])
        print(f"fit: {model}")
        result["fit"] = {"t_s": model.t_s, "alpha_s": model.alpha_s,
                         "r2": model.r2}
    _write(out, result)
    return result


def run_grid(processors: int, families=SCHEDULERS,
             sets=TASK_SETS, max_active: int = STREAM_ACTIVE_JOBS,
             out: Optional[Path] = None):
    """The full four-family Table-9 grid at P processors, streamed.

    Each (family, set) is one streamed run: waves of P tasks, at most
    ``max_active`` job arrays materialized at a time (the n=240 rapid set is
    n·P tasks total — 24.6M at P=102,400 — but peak live tasks stay at
    max_active·P).  Per family, (t_s, alpha_s) is refit over the four
    measured Delta-T points, the paper's Table-10 protocol at 73x its scale.
    """
    print(f"# Table 9 full grid: P={processors}, streamed "
          f"(wave=P, max_active={max_active})")
    print("scheduler,set,t,n,T_total_s,delta_t_s,utilization,wall_s")
    result = {"bench": "table9_grid", "P": processors,
              "stream": {"wave_tasks": processors,
                         "max_active_jobs": max_active},
              "families": {}}
    for fam in families:
        rows = []
        for name, t, n in sets:
            w0 = time.time()
            r = run_taskset(fam, n, t, processors=processors,
                            wave_tasks=processors,
                            max_active_jobs=max_active)
            r["set"] = name
            r["wall_s"] = round(time.time() - w0, 1)
            print(f"{fam},{name},{t},{n},{r['T_total']:.1f},"
                  f"{r['delta_t']:.2f},{r['utilization']:.4f},"
                  f"{r['wall_s']}", flush=True)
            rows.append(r)
        model = fit_power_law([r["n"] for r in rows],
                              [r["delta_t"] for r in rows])
        print(f"{fam} fit: {model}", flush=True)
        result["families"][fam] = {
            "rows": rows,
            "fit": {"t_s": model.t_s, "alpha_s": model.alpha_s,
                    "r2": model.r2},
        }
    _write(out, result)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--P", type=int, default=None,
                    help="run the scaled grid at this processor count "
                         "(default: the paper's P=1408 full grid)")
    ap.add_argument("--grid", action="store_true",
                    help="with --P: the full four-family, four-set grid "
                         "(streamed waves) instead of one family")
    ap.add_argument("--family", default="slurm",
                    help="scheduler family for the scaled grid")
    ap.add_argument("--n-values", type=int, nargs="+", default=(1, 2, 4, 8),
                    help="tasks/processor points for the scaled grid")
    ap.add_argument("--max-active", type=int, default=STREAM_ACTIVE_JOBS,
                    help="streaming active-job cap for --grid")
    ap.add_argument("--no-fit", dest="fit", action="store_false",
                    help="skip the (t_s, alpha_s) refit of the scaled runs")
    ap.add_argument("--out", type=Path, default=None,
                    help="write the JSON result here (by default nothing "
                         "is written)")
    args = ap.parse_args(argv)
    if args.grid and not args.P:
        ap.error("--grid needs --P")
    if args.P and args.grid:
        return run_grid(args.P, max_active=args.max_active, out=args.out)
    if args.P:
        return run_scaled(args.P, family=args.family,
                          n_values=tuple(args.n_values), fit=args.fit,
                          out=args.out)
    return run(out=args.out)


if __name__ == "__main__":
    main()
