"""The paper's latency and utilisation model (§4): the parts the dispatch
benchmark uses, copied from the reference's ``core/latency_model.py``.

  Delta_T = t_s * n^alpha_s            non-execution latency of n tasks
  U_c(t)^{-1} ~= 1 + t_s / t           (alpha_s ~= 1)

Fitting: log-log least squares of Delta_T against n gives (t_s, alpha_s),
the paper's Table 10 parameters.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np


def utilization_approx(t, t_s: float):
    """U_c(t) ~= 1 / (1 + t_s/t) (paper Fig. 5a dotted lines)."""
    return 1.0 / (1.0 + t_s / np.asarray(t, dtype=float))


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
