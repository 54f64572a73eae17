"""Logical-axis sharding: maps model-level axis names to mesh axes.

The counterpart of the reference's ``distributed/sharding.py``, over
``torch.distributed``'s ``DeviceMesh`` and DTensor. Models annotate
activations with ``constrain(x, "batch", "seq", "embed")``; parameters get
logical axes from their tree path (``_PARAM_RULES``). A ``ShardingRules``
object (per arch × mesh) resolves logical names to mesh axes. Outside an
active rules context every annotation returns its input, so the same model
code runs meshless on one device.

A spec is a tuple with the semantics of JAX's ``PartitionSpec``: one entry
per leading dimension, each None, a mesh axis name or a tuple of names,
trailing Nones trimmed, a mesh axis used at most once. ``placements`` turns
a spec into DTensor placements, one per mesh dimension: ``Shard(d)`` where
the axis splits tensor dimension d, else ``Replicate()``. A dimension split
over two axes ("pod", "data") is split major axis first, as in JAX; DTensor
splits in mesh-dimension order, so the axes of one entry must come in the
mesh's order (the rules only make such entries).

Spec trees have the structure of the tree they describe, with a spec tuple
for each leaf; walk them with ``spec_leaves`` (``repro_torch.tree`` would
take a tuple for a node).
"""
from __future__ import annotations

import contextlib
import re
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import tree as tree_lib
from repro_torch.launch.mesh import axis_names, axis_sizes

# thread-local active context, so constrain() needs no mesh threaded
# through every layer call
_ctx = threading.local()

Spec = Tuple[Any, ...]


def _shape(x) -> Tuple[int, ...]:
    """Shape of a tensor, numpy array or (shape, dtype) pair."""
    if isinstance(x, tuple) and len(x) == 2 and isinstance(x[1], torch.dtype):
        return tuple(x[0])
    return tuple(x.shape) if hasattr(x, "shape") else tuple(np.shape(x))


@dataclass(frozen=True)
class ShardingRules:
    """Mapping logical axis name -> mesh axis (or tuple of axes, or None)."""

    rules: Dict[str, Any] = field(default_factory=dict)

    def spec(self, logical_axes: Sequence[Optional[str]],
             shape: Optional[Sequence[int]] = None,
             axis_sizes: Optional[Dict[str, int]] = None) -> Spec:
        """Resolve logical axes; when ``shape`` and ``axis_sizes`` are
        given, mesh axes that do not divide the dimension are dropped
        (replicated)."""
        phys: List[Any] = []
        used: set = set()
        for i, name in enumerate(logical_axes):
            axes = self.rules.get(name) if name else None
            if axes is None:
                phys.append(None)
                continue
            if isinstance(axes, str):
                axes = (axes,)
            # a mesh axis may appear at most once in a spec
            axes = tuple(a for a in axes if a not in used)
            if shape is not None and axis_sizes is not None and axes:
                kept = []
                rem = shape[i]
                for a in axes:
                    if rem % axis_sizes.get(a, 1) == 0:
                        kept.append(a)
                        rem //= axis_sizes[a]
                axes = tuple(kept)
            used.update(axes)
            if not axes:
                phys.append(None)
            else:
                phys.append(axes if len(axes) != 1 else axes[0])
        while phys and phys[-1] is None:
            phys.pop()
        return tuple(phys)


def _axes_of(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def default_rules(mesh, cfg=None) -> ShardingRules:
    """Production rules for the (pod?, data, model) mesh.

    batch  -> all data-parallel axes (pod, data)
    model-parallel dims (heads, ffn, vocab) -> model
    experts -> the data-parallel axes when divisible (expert parallelism),
               so expert weights are fully sharded across the mesh.
    """
    sizes = axis_sizes(mesh)
    dp_axes = tuple(a for a in ("pod", "data") if a in sizes)
    rules: Dict[str, Any] = {
        "batch": dp_axes,
        "seq": None,
        "kv_seq": None,   # K/V sequence: stays replicated under seq-parallel
        "embed": None,
        "heads": "model",
        "kv_heads": None,  # resolved below
        "head_dim": None,
        "ffn": "model",
        "vocab": "model",
        "expert_ffn": "model",
        "experts": None,   # resolved below
        "state": None,
        "conv": None,
        "ssm_inner": "model",
        "frontend": None,
        "seq_sp": None,    # sequence-parallel axis, enabled per shape
    }
    if cfg is not None:
        model_size = sizes.get("model", 1)
        if cfg.n_kv_heads % model_size == 0 and cfg.n_kv_heads >= model_size:
            rules["kv_heads"] = "model"
        if cfg.n_heads % model_size != 0:
            # head counts that do not divide the model axis (gemma 8,
            # arctic 56, phi4 24): shard head_dim instead (a contraction
            # all-reduce)
            rules["heads"] = None
            rules["head_dim"] = "model"
        if cfg.moe.enabled:
            dp_total = int(np.prod([sizes[a] for a in dp_axes])) if dp_axes else 1
            if dp_axes and cfg.moe.n_experts % dp_total == 0:
                rules["experts"] = dp_axes
            elif "data" in sizes and cfg.moe.n_experts % sizes["data"] == 0:
                rules["experts"] = ("data",)
            elif cfg.moe.n_experts % model_size == 0:
                rules["experts"] = "model"
                rules["expert_ffn"] = None
    return ShardingRules(rules)


@contextlib.contextmanager
def use_rules(mesh, rules: Optional[ShardingRules]):
    prev = getattr(_ctx, "state", None)
    _ctx.state = (mesh, rules) if mesh is not None else None
    try:
        yield
    finally:
        _ctx.state = prev


def active() -> Optional[Tuple[Any, ShardingRules]]:
    return getattr(_ctx, "state", None)


def placements(spec: Spec, ndim: int, mesh) -> Tuple[Any, ...]:
    """DTensor placements of a tensor of ``ndim`` dimensions laid out by
    ``spec`` on ``mesh``: ``Shard(d)`` on each mesh dimension whose axis
    splits tensor dimension d, ``Replicate()`` on the others. An axis of
    size 1 splits nothing, so it is ``Replicate()`` too (the same layout;
    DTensor refuses some views of a dimension sharded over one device)."""
    from torch.distributed.tensor import Replicate, Shard

    names = axis_names(mesh)
    sizes = axis_sizes(mesh)
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than {ndim} dims")
    out: List[Any] = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = _axes_of(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(
                f"spec entry {entry} splits dim {d} over mesh axes out of the "
                f"mesh's order {names}; DTensor splits in mesh order")
        for i in idx:
            if sizes[names[i]] > 1:
                out[i] = Shard(d)
    return tuple(out)


def distribute(x: torch.Tensor, mesh, spec: Spec):
    """``x`` (the full tensor, the same on every rank) as a DTensor laid
    out by ``spec``; each rank keeps its shard, no data moves. A DTensor
    is redistributed."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    pl = placements(spec, x.dim(), mesh)
    if isinstance(x, DTensor):
        return x if tuple(x.placements) == pl else x.redistribute(mesh, pl)
    return distribute_tensor(x, mesh, pl, src_data_rank=None)


def constrain(x, *logical_axes: Optional[str]):
    """Lay ``x`` out as the logical axes say if a rules context is active.

    Axes that do not divide the corresponding dimension are dropped, so the
    same model code works at any batch or sequence size. Outside a rules
    context ``x`` is returned as it is. Inside one a DTensor is
    redistributed (a plain tensor counts as replicated)."""
    state = active()
    if state is None:
        return x
    from torch.distributed.tensor import DTensor, Replicate

    mesh, rules = state
    spec = rules.spec(logical_axes, shape=x.shape, axis_sizes=axis_sizes(mesh))
    pl = placements(spec, x.dim(), mesh)
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * len(pl),
                               run_check=False)
    return x if tuple(x.placements) == pl else x.redistribute(mesh, pl)


def split_evenly(x, dim: int, size: int):
    """``x`` with dimension ``dim`` split only over mesh axes whose
    product divides ``size``, the length that dimension takes in a reshape
    that follows (DTensor cannot unflatten an uneven split; XLA
    reshards). A plain tensor is returned as it is."""
    if not hasattr(x, "placements"):
        return x
    from torch.distributed.tensor import Replicate

    mesh, pl, ways = x.device_mesh, list(x.placements), 1
    for i, p in enumerate(pl):
        if p.is_shard(dim):
            if size % (ways * mesh.size(i)):
                pl[i] = Replicate()
            else:
                ways *= mesh.size(i)
    return x if pl == list(x.placements) else x.redistribute(mesh, pl)


def _bmm_placement(pa, pb):
    """The output placement of bmm(a [b,m,k], b [b,k,n]) on one mesh
    dimension where the inputs are ``pa`` and ``pb`` and no data need
    move, or None."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    def plain_shard(p, d):
        return type(p) is Shard and p.dim == d

    def partial_sum(p):
        return p.is_partial() and getattr(p, "reduce_op", "sum") == "sum"

    if pa == pb and getattr(pa, "dim", None) == 0 and (
            pa.is_shard() or type(pa).__name__ == "_StridedShard"):
        return pa                        # the same batch split, strided too
    if pa.is_replicate() and pb.is_replicate():
        return Replicate()
    if plain_shard(pa, 1) and pb.is_replicate():
        return Shard(1)
    if pa.is_replicate() and plain_shard(pb, 2):
        return Shard(2)
    if plain_shard(pa, 2) and plain_shard(pb, 1):
        return Partial()
    if ((partial_sum(pa) and pb.is_replicate())
            or (pa.is_replicate() and partial_sum(pb))):
        return Partial()
    return None


def _bmm_handler(op_call, args, kwargs):
    """aten.bmm on DTensors whose layouts need no communication: the local
    bmm and the placements it implies. DTensor's own strategy search takes
    seconds for a batch split over two mesh axes (a strided shard) on a
    2-D mesh and minutes on a 3-D one; other layouts go to it."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._dtensor_spec import DTensorSpec, TensorMeta

    a, b = args
    out = None
    if (isinstance(a, DTensor) and isinstance(b, DTensor) and not kwargs
            and a.device_mesh == b.device_mesh):
        # both split on the batch dim over one mesh dim, but differently
        # (one strided): the strided one is laid out as the other
        want_a, want_b = list(a.placements), list(b.placements)
        for i, (pa, pb) in enumerate(zip(want_a, want_b)):
            if (pa != pb and getattr(pa, "dim", None) == 0
                    and getattr(pb, "dim", None) == 0):
                if type(pa).__name__ == "_StridedShard":
                    want_a[i] = pb
                else:
                    want_b[i] = pa
        # other pairs no rule takes: replicate an operand there, the
        # smaller where either would do
        from torch.distributed.tensor import Replicate

        for i, (pa, pb) in enumerate(zip(want_a, want_b)):
            if _bmm_placement(pa, pb) is not None:
                continue
            a_ok = _bmm_placement(Replicate(), pb) is not None
            b_ok = _bmm_placement(pa, Replicate()) is not None
            if a_ok and (not b_ok or a.numel() <= b.numel()):
                want_a[i] = Replicate()
            elif b_ok:
                want_b[i] = Replicate()
            else:
                want_a[i] = want_b[i] = Replicate()
        if want_a != list(a.placements):
            a = a.redistribute(a.device_mesh, want_a)
        if want_b != list(b.placements):
            b = b.redistribute(b.device_mesh, want_b)
        out = [_bmm_placement(pa, pb)
               for pa, pb in zip(a.placements, b.placements)]
    if out is None or any(p is None for p in out):
        return _default(op_call, _bmm_handler, args, kwargs)
    local = torch.bmm(a._local_tensor, b._local_tensor)
    shape = torch.Size((a.shape[0], a.shape[1], b.shape[2]))
    meta = TensorMeta(shape, (shape[1] * shape[2], shape[2], 1), local.dtype)
    return DTensor(local, DTensorSpec(a.device_mesh, tuple(out),
                                      tensor_meta=meta),
                   requires_grad=local.requires_grad)


def _default(op_call, handler, args, kwargs):
    """``op_call`` through DTensor's own dispatch, ``handler`` set aside."""
    from torch.distributed.tensor import DTensor

    handlers = DTensor._op_dispatcher._custom_op_handlers
    handlers.pop(op_call)
    try:
        return op_call(*args, **(kwargs or {}))
    finally:
        handlers[op_call] = handler


def _view_handler(op_call, args, kwargs):
    """aten.view / _unsafe_view on a DTensor that DTensor refuses to view
    as it is laid out (some versions refuse to merge dimensions of which a
    later one is split): the split mesh dimensions are replicated, the
    last first, until the view is taken (newer versions do the same
    themselves)."""
    from torch.distributed.tensor import Replicate

    handler = _HANDLERS[op_call]
    try:
        return _default(op_call, handler, args, kwargs)
    except RuntimeError:
        x = args[0]
        pl = list(x.placements)
        for i in reversed(range(len(pl))):
            if pl[i].is_replicate() or pl[i].is_partial():
                continue
            pl[i] = Replicate()
            try:
                return _default(op_call, handler, (x.redistribute(
                    x.device_mesh, pl),) + tuple(args[1:]), kwargs)
            except RuntimeError:
                continue
        raise


def _detach_handler(op_call, args, kwargs):
    """aten.detach_ on a DTensor: autograd detaches above the dispatch; the
    op itself returns its input (some DTensor versions have no strategy
    for it; activation checkpointing calls it)."""
    return args[0]


def _flip_handler(op_call, args, kwargs):
    """aten.flip on a DTensor (the backward of cumsum; some DTensor
    versions have no strategy for it): the local flip where no flipped
    dimension is split, after replicating the split ones otherwise."""
    from torch.distributed.tensor import DTensor, Replicate

    x, dims = args[0], [d % args[0].dim() for d in args[1]]
    pl = [Replicate() if p.is_shard() and p.dim in dims else p
          for p in x.placements]
    if pl != list(x.placements):
        x = x.redistribute(x.device_mesh, pl)
    return DTensor.from_local(torch.flip(x._local_tensor, dims),
                              x.device_mesh, x.placements, run_check=False,
                              shape=x.shape, stride=x.stride())


_HANDLERS = {torch.ops.aten.bmm.default: _bmm_handler,
             torch.ops.aten.view.default: _view_handler,
             torch.ops.aten._unsafe_view.default: _view_handler,
             torch.ops.aten.detach_.default: _detach_handler,
             torch.ops.aten.flip.default: _flip_handler}


@contextlib.contextmanager
def dtensor_handlers():
    """``_HANDLERS`` for their ops on DTensors inside the block."""
    from torch.distributed.tensor import DTensor

    handlers = DTensor._op_dispatcher._custom_op_handlers
    before = {op: handlers.get(op) for op in _HANDLERS}
    handlers.update(_HANDLERS)
    try:
        yield
    finally:
        for op, h in before.items():
            if h is None:
                handlers.pop(op, None)
            else:
                handlers[op] = h


def backward_views(mesh):
    """A context for a backward pass on ``mesh``: there, a view of a
    strided gradient shard that cannot be a view is taken as a reshape
    (a copy). DTensor can take such a shard for a contiguous one (the
    gradient of a transpose that follows a reshape, as in a 3-D matmul or
    an einsum) and fail to view it; plain tensors copy there. Nothing is
    pushed on a mesh of one device, where every shard is its tensor."""
    import math

    if math.prod(axis_sizes(mesh).values()) == 1:
        return contextlib.nullcontext()
    return _BackwardViews()


def _backward_views_cls():
    from torch.utils._python_dispatch import TorchDispatchMode

    class _BackwardViewsMode(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            from torch.distributed.tensor import DTensor

            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            if (func is torch.ops.aten.view.default
                    and not args[0].is_contiguous()
                    and torch._C._current_autograd_node() is not None):
                try:
                    return func(*args, **(kwargs or {}))
                except RuntimeError:
                    return args[0].reshape(args[1])
            return func(*args, **(kwargs or {}))

    return _BackwardViewsMode


def _BackwardViews():
    return _backward_views_cls()()


# ---------------------------------------------------------------------------
# Parameter logical axes by tree path
# ---------------------------------------------------------------------------

# Ordered (regex on joined path, logical axes per dim — trailing dims matched
# right-aligned; leading unmatched dims get None, e.g. the scan-group dim).
_PARAM_RULES: Tuple[Tuple[str, Tuple[Optional[str], ...]], ...] = (
    (r"tok_embed$", ("vocab", "embed")),
    (r"lm_head$", ("embed", "vocab")),
    (r"frontend_proj$", ("frontend", "embed")),
    (r"wq$", ("embed", "heads", "head_dim")),
    (r"wk$", ("embed", "kv_heads", "head_dim")),
    (r"wv$", ("embed", "kv_heads", "head_dim")),
    (r"wo$", ("heads", "head_dim", "embed")),
    (r"(w_gate|w_up)$", ("embed", "ffn")),
    (r"w_down$", ("ffn", "embed")),
    (r"router$", ("embed", "experts")),
    (r"experts?/.*(w_gate|w_up)$", ("experts", "embed", "expert_ffn")),
    (r"experts?/.*w_down$", ("experts", "expert_ffn", "embed")),
    (r"(in_proj|in_proj_x|in_proj_z)$", ("embed", "ssm_inner")),
    (r"conv_w$", ("conv", "ssm_inner")),
    (r"(x_dt|x_b|x_c)$", ("ssm_inner", None)),
    (r"dt_proj$", (None, "ssm_inner")),
    (r"(a_log|ssm_d|dt_bias)$", ("ssm_inner", "state")),
    (r"out_proj$", ("ssm_inner", "embed")),
    # xlstm
    (r"(up_proj|gate_proj)$", ("embed", "ssm_inner")),
    (r"down_proj$", ("ssm_inner", "embed")),
    (r"(wq_x|wk_x|wv_x|wi_x|wf_x|wo_x)$", ("ssm_inner", None)),
    (r"(rq|rk|rv|ri|rf|ro|rz)$", (None, None)),
    (r"(wi|wf|wz|wo_g)$", ("embed", None)),
)


def logical_axes_for(path: str, ndim: int) -> Tuple[Optional[str], ...]:
    """Logical axes for a parameter at ``path`` with ``ndim`` dims."""
    for pat, axes in _PARAM_RULES:
        if re.search(pat, path):
            axes = tuple(axes)
            if len(axes) > ndim:
                axes = axes[len(axes) - ndim:]
            return (None,) * (ndim - len(axes)) + axes
    return (None,) * ndim


def _paths(tree, prefix: str = "") -> List[str]:
    """'/'-joined key paths of the leaves of ``tree``, in leaf order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in _paths(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [p for k, v in zip(tree._fields, tree)
                for p in _paths(v, f"{prefix}{k}/")]
    if isinstance(tree, (tuple, list)):
        return [p for i, v in enumerate(tree)
                for p in _paths(v, f"{prefix}{i}/")]
    return [prefix[:-1]]


def tree_paths(tree) -> Any:
    """Tree of '/'-joined key paths, same structure as ``tree``."""
    return tree_lib.unflatten(tree, _paths(tree))


def spec_leaves(specs, like) -> List[Spec]:
    """The specs of a spec tree in the leaf order of ``like``, the tree
    it describes."""
    if isinstance(like, dict):
        return [s for k in sorted(like) for s in spec_leaves(specs[k], like[k])]
    if isinstance(like, (tuple, list)):
        return [s for a, b in zip(specs, like) for s in spec_leaves(a, b)]
    return [specs]


def _map_specs(fn, tree) -> Any:
    """Spec tree of ``fn(path, leaf)`` over the leaves of ``tree``."""
    return tree_lib.unflatten(tree, [fn(p, x) for p, x in zip(
        _paths(tree), tree_lib.leaves(tree))])


def param_specs(params, rules: ShardingRules, mesh=None):
    """Spec tree for a parameter tree (divisibility-guarded against
    ``mesh`` when given)."""
    sizes = axis_sizes(mesh) if mesh is not None else None
    return _map_specs(lambda p, x: rules.spec(
        logical_axes_for(p, len(_shape(x))),
        shape=_shape(x) if sizes is not None else None, axis_sizes=sizes),
        params)


def shard_tree(tree, specs, mesh):
    """``tree`` with every leaf distributed by its spec (a leaf whose spec
    is None stays a plain tensor)."""
    return tree_lib.unflatten(tree, [
        x if s is None else distribute(x, mesh, s)
        for x, s in zip(tree_lib.leaves(tree), spec_leaves(specs, tree))])


def param_shardings(params, mesh, rules: ShardingRules):
    """``params`` distributed over ``mesh`` by ``param_specs``."""
    return shard_tree(params, param_specs(params, rules, mesh), mesh)


def zero1_specs(params, rules: ShardingRules, mesh):
    """Optimizer-state specs: params' specs with data-parallel axes added
    to the largest still-unsharded, divisible dimension (ZeRO-1)."""
    sizes = axis_sizes(mesh)
    dp_axes = tuple(a for a in ("pod", "data") if a in sizes)
    dp_total = int(np.prod([sizes[a] for a in dp_axes])) if dp_axes else 1

    def add_dp(path, x) -> Spec:
        shape = _shape(x)
        spec = rules.spec(logical_axes_for(path, len(shape)), shape=shape,
                          axis_sizes=sizes)
        if dp_total == 1 or len(shape) == 0:
            return spec
        entries = list(spec) + [None] * (len(shape) - len(spec))
        used = {a for e in entries for a in _axes_of(e)}
        if any(a in used for a in dp_axes):
            return spec  # already data-sharded (e.g. experts)

        def shard_size(dim, e):
            den = 1
            for a in _axes_of(e):
                den *= sizes[a]
            return shape[dim] // den
        cands = [
            (shard_size(d, e), d)
            for d, e in enumerate(entries)
            if e is None and shard_size(d, None) % dp_total == 0
            and shape[d] >= dp_total
        ]
        if not cands:
            return spec
        _, dim = max(cands)
        entries[dim] = dp_axes if len(dp_axes) > 1 else dp_axes[0]
        while entries and entries[-1] is None:
            entries.pop()
        return tuple(entries)

    return _map_specs(add_dp, params)
