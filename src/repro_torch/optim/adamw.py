"""AdamW with decoupled weight decay, global-norm clipping, cosine schedule.

The reference's update, step for step: m and v are float32 whatever the
parameter's dtype; the gradients are clipped to ``grad_clip`` global norm
before the moments; the bias corrections and the learning rate are taken
at the new step (``step + 1``); the update is
``u = m·c1 / (sqrt(v·c2) + eps)``, plus ``weight_decay · p`` on every
leaf of two or more dimensions (judged on the stacked shapes, so the
per-group norm scales ``[G, d]`` decay too, as in the reference); the new
parameter is computed in float32 and cast to the leaf's dtype once.

Unlike the reference, which returns new arrays and lets XLA donate the old
ones, ``update`` writes the parameters, m, v and the step counter in
place, leaf by leaf and in flat pieces of at most ``CHUNK`` elements, so
that a step never holds a second copy of the state: its float32
temporaries are a few pieces' worth. ``torch.optim.AdamW`` is not used: it
decays ``p`` in the parameter's dtype before the step, which rounds
differently in bf16.

Each ``a·b + c`` of the update is one fused multiply-add (``add`` with
``alpha``, ``addcmul``), rounded once, because that is what XLA makes of
the reference's expressions (on the CPU every result equals
``fma(b1, m, (1 - b1)·g)``, not the twice-rounded sum); so on the same
gradients the port's update equals the reference's bit for bit.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch

from repro_torch import tree as tree_lib

_F32 = torch.float32
# elements per piece of a leaf in the update: 128 MB of float32 temporaries
CHUNK = 1 << 25


class OptState(NamedTuple):
    step: torch.Tensor           # int32 scalar
    m: Any                       # float32 tree like params
    v: Any                       # float32 tree like params


def _pieces(t: torch.Tensor):
    return t.view(-1).split(CHUNK)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32, as a plain
    tensor. DTensor leaves: each rank sums its shards' pieces in leaf
    order, one running sum for each set of mesh dimensions that split a
    leaf; each sum is reduced over its dimensions, and the sums are added
    in the order they first appear (one sum on a mesh of one device, so
    the same additions as for plain leaves)."""
    totals: Dict[Tuple[int, ...], Any] = {}
    for x in tree_lib.leaves(tree):
        key = _split_dims(x)
        for piece in _pieces(_local(x)):
            s = piece.float().square().sum()
            totals[key] = s if key not in totals else totals[key] + s
    total = None
    for key, s in totals.items():
        if key:
            s = _reduce_over(s, key, tree_lib.leaves(tree)[0].device_mesh)
        total = s if total is None else total + s
    return torch.sqrt(total)


def _split_dims(x) -> Tuple[int, ...]:
    """Mesh dimensions of more than one device that split a DTensor."""
    if not hasattr(x, "placements"):
        return ()
    mesh = x.device_mesh
    return tuple(i for i, pl in enumerate(x.placements)
                 if pl.is_shard() and mesh.size(i) > 1)


def _reduce_over(s: torch.Tensor, dims, mesh) -> torch.Tensor:
    """The sum of a per-rank scalar over mesh dimensions ``dims``."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    pl = [Partial() if i in dims else Replicate() for i in range(mesh.ndim)]
    return DTensor.from_local(s, mesh, pl, run_check=False).full_tensor()


def cosine_schedule(base_lr: float, warmup_steps: int, total_steps: int,
                    min_ratio: float = 0.1) -> Callable:
    """lr(step): linear warmup to ``base_lr``, then a cosine down to
    ``min_ratio · base_lr`` at ``total_steps``; float32 throughout. The
    divisions by the constant step counts are multiplications by their
    float32 reciprocals, which is what XLA compiles the reference's to."""
    inv_warm = float(torch.tensor(1 / max(warmup_steps, 1), dtype=_F32))
    inv_decay = float(torch.tensor(1 / max(total_steps - warmup_steps, 1),
                                   dtype=_F32))

    def lr(step: torch.Tensor) -> torch.Tensor:
        step = step.to(_F32)
        warm = torch.clamp_max(step * inv_warm, 1.0)
        frac = torch.clamp((step - warmup_steps) * inv_decay, 0.0, 1.0)
        # min_ratio + (1 - min_ratio)/2 · (1 + cos), the product fused into
        # the sum as XLA fuses it
        cos = torch.add(torch.full_like(frac, min_ratio),
                        1 + torch.cos(math.pi * frac),
                        alpha=(1 - min_ratio) * 0.5)
        return base_lr * warm * cos
    return lr


@dataclass(frozen=True)
class AdamW:
    learning_rate: Any = 3e-4      # float or schedule fn(step) -> lr
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0

    def init(self, params) -> OptState:
        leaves = tree_lib.leaves(params)
        device = leaves[0].device if leaves else None

        def zeros(p):
            return torch.zeros(p.shape, dtype=_F32, device=p.device)

        return OptState(
            step=torch.zeros((), dtype=torch.int32, device=device),
            m=tree_lib.map_tree(zeros, params),
            v=tree_lib.map_tree(zeros, params))

    @torch.no_grad()
    def update(self, grads, state: OptState,
               params) -> Tuple[Any, OptState, Dict[str, torch.Tensor]]:
        """One step, in place: params, m, v and step are overwritten and
        returned. Returns (params, state, {"grad_norm", "lr"}).

        On a mesh (DTensor leaves) each gradient is first laid out as its
        m and v (reduced from partial sums, split further where ZeRO-1
        splits the moments), the update runs on every rank's local shards
        with the same operations in the same order, and a parameter laid
        out otherwise than its moments is updated in their layout and laid
        back. The global norm sums each leaf's local pieces as the meshless
        update does, then reduces over the mesh dimensions that split the
        leaf; on a mesh of one device every number is the meshless one."""
        p_leaves, g_leaves, m_leaves, v_leaves = (
            tree_lib.leaves(t) for t in (params, grads, state.m, state.v))
        g_leaves = [_like(g, m) for g, m in zip(g_leaves, m_leaves)]
        state.step.add_(1)
        step = state.step.to(_F32)
        gnorm = global_norm(g_leaves)
        scale = (torch.clamp_max(self.grad_clip / (gnorm + 1e-9), 1.0)
                 if self.grad_clip > 0 else None)
        lr = (self.learning_rate(state.step)
              if callable(self.learning_rate)
              else torch.tensor(self.learning_rate, dtype=_F32,
                                device=step.device))
        neg_lr = -lr
        b1, b2 = self.b1, self.b2
        c1 = 1.0 / (1 - torch.pow(torch.tensor(b1, dtype=_F32,
                                               device=step.device), step))
        c2 = 1.0 / (1 - torch.pow(torch.tensor(b2, dtype=_F32,
                                               device=step.device), step))
        for p, g, m, v in zip(p_leaves, g_leaves, m_leaves, v_leaves):
            decay = self.weight_decay > 0 and p.dim() >= 2
            p_here = _like(p, m)
            # a shard taken from a replicated leaf may be a strided view
            p_loc = (_local(p) if p_here is p
                     else _local(p_here).contiguous())
            for pp, gp, mp, vp in zip(*(_pieces(t) for t in (
                    p_loc, _local(g).contiguous(), _local(m), _local(v)))):
                g32 = gp.float()
                if scale is not None:
                    g32 = g32 * scale
                # b·m + (1 - b)·g with b·m fused into the sum (one
                # rounding), as XLA compiles the reference's expression
                torch.add(g32 * (1 - b1), mp, alpha=b1, out=mp)
                torch.add(g32 * (1 - b2) * g32, vp, alpha=b2, out=vp)
                del g32
                u = (mp * c1) / (torch.sqrt(vp * c2) + self.eps)
                p32 = pp.float()
                if decay:
                    u.add_(p32, alpha=self.weight_decay)
                pp.copy_(torch.addcmul(p32, u, neg_lr))
            if p_here is not p:
                from torch.distributed.tensor import DTensor

                p_here = DTensor.from_local(p_loc, m.device_mesh,
                                            m.placements, run_check=False)
                _local(p).copy_(_local(_like(p_here, p)))
        return params, state, {"grad_norm": gnorm, "lr": lr}


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's shard on this rank; a plain tensor itself."""
    return t.to_local() if hasattr(t, "to_local") else t


def _like(t: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``t`` laid out as ``ref`` on its mesh (``t`` itself if both are
    plain or already alike)."""
    if not hasattr(t, "placements") or t.placements == ref.placements:
        return t
    return t.redistribute(ref.device_mesh, ref.placements)
