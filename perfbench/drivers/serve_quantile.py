"""Serving driver ``serve`` with the served gaps' spread beside the widest.

The run and its check are the ``serve`` driver's, unchanged: its clients,
window, sample, reference and ``serve.served_gaps``. The reference is
handed to them wrapped, so that each of its calls records the gap at
every served position it judges (max(logits) − logits[served token],
each request's last served position excepted, whose token the call does
not see). From those gaps the check adds:

- ``served_gap_p90``: the 90th percentile over every recorded position;
- ``served_gap_request_median``: the largest, over the checked requests,
  of a request's median gap.

With a control, the same two numbers of the gaps of the token the
control puts first. The mix key ``"control": true`` (for
``calibrate.py --overrides '{"mix": {"control": true}}'``, which takes a
control itself only for the driver named ``serve``) computes the
control in the run; the benchmark's runs never set it.

Why: in a deep model of sparse experts with random weights, a one-ulp
bf16 difference flips a routed expert now and then, and a flipped route
moves a position's logits by units. The widest gap of a sound bf16
program then reaches the fp8 control's (PERF.md §6). Most
positions flip no route: the 90th percentile keeps the program and the
control apart, and fails a fault in more than a tenth of the positions;
a request's median fails one wrong request, whatever its share.
"""
from __future__ import annotations

import math
import statistics
from types import SimpleNamespace

import torch

from perfbench import registry

NAMES = ("served_gap_p90", "served_gap_request_median")


def run(ctx):
    serve = registry.driver("serve")
    control = ctx.control
    if control is None and ctx.mix.get("control"):
        control = ctx.ref.control_for(ctx.cfg)
    ref = _Recorder(ctx.ref)
    rec = serve.run(SimpleNamespace(**dict(vars(ctx), ref=ref,
                                           control=control)))
    widest = rec.checks["served_gap"]
    rec.checks.update(spread(ref.gaps, widest))
    if rec.control is not None:
        rec.control.update(spread(ref.control_gaps, widest))
    return rec


def served_gaps(ctx, checked, quant=None) -> dict:
    """``serve.served_gaps``'s numbers, and under ``"program"`` (and with
    ``quant`` under ``"control"``) this driver's two."""
    ref = _Recorder(ctx.ref)
    out = registry.driver("serve").served_gaps(
        SimpleNamespace(**dict(vars(ctx), ref=ref)), checked, quant)
    return dict(out, program=spread(ref.gaps, out["gap"]),
                control=None if quant is None
                else spread(ref.control_gaps, out["gap"]))


def spread(gaps, widest: float) -> dict:
    """The two numbers of per-request gap lists; inf where the widest gap
    is (a token outside the vocabulary, no request checked) or nothing
    was recorded."""
    every = [g for request in gaps for g in request]
    if not math.isfinite(widest) or not every:
        return dict.fromkeys(NAMES, math.inf)
    return {"served_gap_p90": statistics.quantiles(
                every, n=10, method="inclusive")[-1],
            "served_gap_request_median": max(
                statistics.median(request) for request in gaps if request)}


class _Recorder:
    """The cell's reference, recording per call the gaps at the positions
    whose served token the call's own tokens hold; with ``quant``, the
    gaps of the token the lower precision puts first, against the plain
    call just before it (``serve.served_gaps`` makes that call first)."""

    def __init__(self, ref):
        self._ref = ref
        self.gaps, self.control_gaps = [], []
        self._plain = None

    def served_logits(self, cfg, params, tokens, start, device, quant=None):
        logits = self._ref.served_logits(cfg, params, tokens, start, device,
                                         quant=quant)
        if quant is None:
            self._plain = logits
            served = torch.as_tensor(tokens[start + 1:],
                                     device=logits.device)
            self.gaps.append(_gaps(logits[:-1], served))
        else:
            plain, self._plain = self._plain, None
            self.control_gaps.append(_gaps(plain[:-1],
                                           logits[:-1].argmax(dim=-1)))
        return logits

    def __getattr__(self, name):
        return getattr(self._ref, name)


def _gaps(logits, tokens) -> list:
    best = logits.max(dim=-1).values
    return (best - logits.gather(-1, tokens[:, None])[:, 0]).tolist()
