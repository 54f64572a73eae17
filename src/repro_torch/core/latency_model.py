"""The paper's latency and utilization models (§4) plus parameter fitting.

  T_total(N, P) = T_job + Delta_T,  T_job = t*n,  Delta_T = t_s * n^alpha_s
  U_c^{-1}      = 1 + (t_s n^alpha_s) / (t n)     (constant task times)
  U_c(t)^{-1}  ~= 1 + t_s / t                     (alpha_s ~= 1)
  U_v(p)^{-1}  ~= 1 + t_s / mean_t(p)             (variable task times)
  U^{-1}       ~= P^{-1} sum_p U_c(mean_t(p))^{-1}

Fitting: log-log least squares of Delta_T against n gives (t_s, alpha_s) —
the paper's Table 10 parameters.

A copy of the reference's ``repro/core/latency_model.py``; test files named
below are the reference's, and ``tests/test_torch_scheduler.py`` holds this
copy equal to the reference.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np


def delta_t(n, t_s: float, alpha_s: float):
    """Non-execution latency for n tasks/processor."""
    return t_s * np.asarray(n, dtype=float) ** alpha_s


def total_runtime(n, t: float, t_s: float, alpha_s: float):
    return t * np.asarray(n, dtype=float) + delta_t(n, t_s, alpha_s)


def utilization_constant(t, n, t_s: float, alpha_s: float):
    """Exact U_c from the model (paper Fig. 5b dashed lines)."""
    n = np.asarray(n, dtype=float)
    return 1.0 / (1.0 + (t_s * n ** alpha_s) / (np.asarray(t, float) * n))


def utilization_approx(t, t_s: float):
    """U_c(t) ~= 1 / (1 + t_s/t) (paper Fig. 5a dotted lines)."""
    return 1.0 / (1.0 + t_s / np.asarray(t, dtype=float))


def utilization_variable(task_times_per_proc: Sequence[Sequence[float]],
                         t_s: float, alpha_s: float = 1.0):
    """U for variable task times: mean of per-processor U_c at mean task time.

    U^{-1} ~= P^{-1} * sum_p (1 + t_s/mean_t(p))
    """
    inv = 0.0
    P = len(task_times_per_proc)
    for times in task_times_per_proc:
        tbar = float(np.mean(times)) if len(times) else 1e-12
        n_p = max(len(times), 1)
        inv += 1.0 + (t_s * n_p ** alpha_s) / (tbar * n_p)
    return P / inv


@dataclass
class ModelFit:
    t_s: float
    alpha_s: float
    r2: float
    n_values: Tuple[float, ...]
    dt_values: Tuple[float, ...]

    def __str__(self) -> str:
        return (f"t_s={self.t_s:.3g}s alpha_s={self.alpha_s:.3g} "
                f"(r2={self.r2:.4f})")


def fit_power_law(n_values: Sequence[float],
                  dt_values: Sequence[float]) -> ModelFit:
    """Least-squares fit of log(dT) = log(t_s) + alpha * log(n)."""
    n = np.asarray(n_values, dtype=float)
    dt = np.maximum(np.asarray(dt_values, dtype=float), 1e-12)
    ln, ldt = np.log(n), np.log(dt)
    A = np.stack([np.ones_like(ln), ln], axis=1)
    coef, *_ = np.linalg.lstsq(A, ldt, rcond=None)
    pred = A @ coef
    ss_res = float(np.sum((ldt - pred) ** 2))
    ss_tot = float(np.sum((ldt - ldt.mean()) ** 2)) or 1e-12
    return ModelFit(
        t_s=float(np.exp(coef[0])), alpha_s=float(coef[1]),
        r2=1.0 - ss_res / ss_tot,
        n_values=tuple(n.tolist()), dt_values=tuple(dt.tolist()))


def estimate_variable_from_constant(curve_t: Sequence[float],
                                    curve_u: Sequence[float],
                                    mean_times_per_proc: Sequence[float]):
    """Paper's claim: the constant-time curve U_c(t), evaluated at each
    processor's mean task time and harmonically averaged, predicts the
    variable-time utilization."""
    t = np.asarray(curve_t, float)
    u = np.asarray(curve_u, float)
    order = np.argsort(t)
    t, u = t[order], u[order]
    inv = 0.0
    for tbar in mean_times_per_proc:
        uc = float(np.interp(tbar, t, u))
        inv += 1.0 / max(uc, 1e-9)
    return len(mean_times_per_proc) / inv
