"""Per-device cost of a step from the operations it dispatches.

The counterpart of the reference's ``launch/hlo_analysis.py``, which
counts FLOPs, traffic and collectives over XLA's optimized HLO and must
recover loop trip counts from it. Here the step runs eagerly under
``OpAnalysis``, a ``TorchDispatchMode``, and every operation that reaches
a device is counted as it runs:

  * it sees DTensor's local operations (it lets DTensor run first, as
    ``CommDebugMode`` does), so every shape is a shard's shape and the
    counts are one device's; the global-shape operations that DTensor's
    sharding propagation runs on fake tensors are skipped;
  * dot FLOPs are 2 · numel(out) · K for mm, addmm, bmm, baddbmm, mv and
    dot, and 2 · numel(out) · (C_in / groups) · prod(kernel) for a
    convolution; a product over K = 1 (an outer product, as autograd makes
    for an einsum's backward) is a multiply, as XLA lowers it and the
    reference counts it;
  * elementwise FLOPs are numel(out) of each operation of the kinds the
    reference counts (``_EW_FLOP_KINDS``: add, multiply, subtract, divide,
    exponential, tanh, rsqrt, sqrt, power, log, maximum, minimum, negate,
    abs, expm1, logistic, cosine, sine), clamps counted as maximum or
    minimum and addcmul/addcdiv as two;
  * traffic is the operand and result bytes of every dispatched operation
    that moves data (views and allocations move none). Eager execution
    does not fuse, so this is the eager path's own traffic, not a proxy
    for a fused program's;
  * collective bytes are max(operand, result) bytes of each
    ``_c10d_functional`` collective, as the reference reckons them.

Eager execution needs no trip counts: every iteration of a Python loop is
dispatched. To keep a full-size dry run short, ``OpAnalysis(roll=True)``
rolls the loops that ``models/loops.py`` marks as alike, on meta tensors
only: four iterations run and each operation of the third counts n − 3
times, forward and backward (the backward operations of autograd nodes
made inside it carry its n − 3 too, so do the gradient sums the engine
makes as their gradients arrive). ``trip_counts`` lists the rolled
loops.
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.models import loops

_EW_FLOP_KINDS = {
    "add", "add_", "mul", "mul_", "sub", "sub_", "rsub", "div", "div_",
    "exp", "exp_", "tanh", "tanh_", "rsqrt", "sqrt", "sqrt_", "pow",
    "log", "log1p", "maximum", "minimum", "neg", "neg_", "abs",
    "expm1", "sigmoid", "cos", "sin", "clamp", "clamp_min", "clamp_max",
    "clamp_min_", "clamp_max_",
}
_EW_TWICE = {"addcmul", "addcmul_", "addcdiv", "addcdiv_"}
_DOTS = {"mm", "addmm", "bmm", "baddbmm", "mv", "dot"}
_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all", "broadcast": "collective-permute",
    "broadcast_": "collective-permute",
}
_NO_TRAFFIC = {"empty", "empty_strided", "empty_like", "new_empty",
               "new_empty_strided", "wait_tensor", "_wrap_tensor_autograd",
               "detach", "alias", "lift_fresh"}


def _tensors(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _is_view(func) -> bool:
    """Every result aliases an input and none is written: a view."""
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None
                              and not r.alias_info.is_write for r in rets)


@dataclass
class OpCost:
    """The fields and ``as_dict()`` of the reference's ``HloCost``."""

    dot_flops: float = 0.0
    elementwise_flops: float = 0.0
    traffic_bytes: float = 0.0
    collective_bytes: float = 0.0
    collectives: Dict[str, Dict[str, float]] = field(default_factory=dict)
    dots: Dict[str, Dict] = field(default_factory=dict)
    trip_counts: Dict[str, int] = field(default_factory=dict)
    unknown_trips: int = 0
    ops: int = 0            # operations dispatched (rolled ones once)

    def as_dict(self) -> Dict:
        top = sorted(self.dots.values(), key=lambda d: -d["flops"])[:12]
        return {
            "dot_flops": self.dot_flops,
            "elementwise_flops": self.elementwise_flops,
            "traffic_bytes": self.traffic_bytes,
            "collective_bytes": self.collective_bytes,
            "collectives": self.collectives,
            "top_dots": top,
            "trip_counts": self.trip_counts,
            "unknown_trips": self.unknown_trips,
            "ops_dispatched": self.ops,
        }


def _seq_nr() -> int:
    """The autograd sequence number the next node will take (from a probe
    node made outside the counting mode)."""
    from torch.utils._python_dispatch import _disable_current_modes

    with _disable_current_modes(), torch.enable_grad():
        x = torch.zeros((), device="meta", requires_grad=True)
        return (x * 1).grad_fn._sequence_nr() + 1


class OpAnalysis(TorchDispatchMode):
    """Counts the operations dispatched inside ``with OpAnalysis() as a``
    into ``a.cost``. With ``device`` (the dry run's "meta"), only
    operations on that device's tensors: DTensor plans some layouts with
    small host tensors the first time it meets them."""

    def __init__(self, roll: bool = False, device: str = ""):
        super().__init__()
        self.cost = OpCost()
        self.roll = roll
        self.device = device
        self._depth = 0
        self._scale = 1
        # (first, last) autograd sequence numbers of nodes made inside a
        # rolled loop, with its n
        self._ranges: List[Tuple[int, int, int]] = []

    # -- rolling ----------------------------------------------------------
    @contextlib.contextmanager
    def scaled(self, n: int):
        """Count what runs inside n times (``models/loops.py``)."""
        key = f"loop{len(self.cost.trip_counts)}"
        self.cost.trip_counts[key] = n
        first = _seq_nr() if torch.is_grad_enabled() else None
        self._scale *= n
        try:
            yield
        finally:
            self._scale //= n
            if first is not None:
                self._ranges.append((first, _seq_nr() - 1, n))

    def _mult(self) -> int:
        mult = self._scale
        node = torch._C._current_autograd_node()
        if node is not None and self._ranges:
            seq = node._sequence_nr()
            for first, last, n in self._ranges:
                if first <= seq <= last:
                    mult *= n
        return mult

    def __enter__(self):
        if self.roll:
            loops.set_roller(self)
        return super().__enter__()

    def __exit__(self, *exc):
        if self.roll:
            loops.set_roller(None)
        return super().__exit__(*exc)

    # -- counting ---------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        from torch._subclasses.fake_tensor import FakeTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented      # let DTensor run its local ops
        kwargs = kwargs or {}
        if self._depth:
            # inside another operation's kernel (a meta kernel written as
            # a decomposition, on its first calls): not an op of the step
            return func(*args, **kwargs)
        self._depth += 1
        try:
            out = func(*args, **kwargs)
        finally:
            self._depth -= 1
        if not isinstance(func, torch._ops.OpOverload):
            return out
        ins, outs = _tensors(args) + _tensors(kwargs), _tensors(out)
        if any(isinstance(t, FakeTensor) for t in ins):
            return out                 # DTensor's shape propagation
        if self.device and not any(t.device.type == self.device
                                   for t in ins + outs):
            return out                 # DTensor's bookkeeping on the host
        self._account(func, ins, outs, args)
        return out

    def _account(self, func, ins, outs, args) -> None:
        cost, mult = self.cost, self._mult()
        cost.ops += 1
        name = func._schema.name.split("::")[-1]
        ns = func.namespace
        if ns == "_c10d_functional" or ns == "c10d_functional":
            kind = _COLLECTIVES.get(name)
            if kind is None:
                return
            b = max(sum(map(_nbytes, ins)), sum(map(_nbytes, outs))) * mult
            d = cost.collectives.setdefault(kind, {"count": 0, "bytes": 0.0})
            d["count"] += mult
            d["bytes"] += b
            cost.collective_bytes += b
            cost.traffic_bytes += (sum(map(_nbytes, ins))
                                   + sum(map(_nbytes, outs))) * mult
            return
        if name in _NO_TRAFFIC or _is_view(func):
            return
        numel = sum(t.numel() for t in outs)
        k = (self._contraction(name, args)
             if name in _DOTS or name == "convolution" else 0)
        if k == 1:
            # an outer product: XLA lowers a dot over one element to a
            # multiply, and the reference counts it as one
            cost.elementwise_flops += numel * mult
        elif k:
            flops = 2.0 * numel * k * mult
            cost.dot_flops += flops
            key = (f"{name}:{tuple(ins[0].shape) if ins else ()}"
                   f"x{tuple(ins[1].shape) if len(ins) > 1 else ()}")
            d = cost.dots.setdefault(key, {"flops": 0.0, "k": k, "mult": 0,
                                           "out": [list(t.shape) for t in outs]})
            d["flops"] += flops
            d["mult"] += mult
        elif name in _EW_FLOP_KINDS:
            cost.elementwise_flops += numel * mult
        elif name in _EW_TWICE:
            cost.elementwise_flops += 2 * numel * mult
        cost.traffic_bytes += (sum(map(_nbytes, ins))
                               + sum(map(_nbytes, outs))) * mult

    @staticmethod
    def _contraction(name: str, args) -> int:
        if name == "convolution":     # weight [C_out, C_in / groups, *k]
            return math.prod(args[1].shape[1:])
        if name in ("addmm", "baddbmm"):
            return args[1].shape[-1]
        return args[0].shape[-1]
