"""Python loops of like iterations, which an op count may roll.

The stack's loop over layer groups, chunked attention's block loops, the
selective scan's and the parallel mLSTM's chunk loops and the sLSTM's loop
over time run n iterations that dispatch the same operations on tensors of
the same shapes, except that the first may differ (its carry is freshly
made, and on a mesh laid out otherwise). They iterate over ``steps``:

    outs = []
    for i in loops.steps(n, x):
        ...
        outs.append(out)
    outs = loops.fill(outs, n)

``steps`` is ``range(n)``, except under a counter that rolls loops (the
dry run's ``launch/op_analysis.py``) when ``like`` lives on the meta
device and n > 4: then it yields 0, 1, 2 and 3 only, and the counter
counts each operation of iteration 2 n − 3 times, forward and backward.
Iterations 0 and 1 stand for themselves (a fresh carry, a carry DTensor
lays out anew), 2 for every middle iteration and 3 for the last, whose
carry takes no gradient from a later one. In the backward pass
autograd's engine adds up a gradient that several iterations give to one
tensor (a weight, the sequence an iteration slices) as it arrives, last
iteration first: iteration 2's sum counts n − 3 times, 1's and 0's once,
n − 1 sums in all as unrolled. Meta tensors hold no values, so iteration
2's tensors stand for every middle iteration's; ``fill`` repeats its
output, detached, so that no gradient is summed over the repeats. Real
tensors always run every iteration.
"""
from __future__ import annotations

from typing import Iterator, List

_roller = None   # the active rolling counter, or None


def set_roller(roller) -> None:
    global _roller
    _roller = roller


def steps(n: int, like) -> Iterator[int]:
    if _roller is None or n <= 4 or like.device.type != "meta":
        yield from range(n)
        return
    yield 0
    yield 1
    with _roller.scaled(n - 3):
        yield 2
    yield 3


def fill(outs: List, n: int) -> List:
    """A rolled loop's outputs as n: the first two, the third n − 3 times
    (detached after its first), the fourth."""
    if len(outs) == n:
        return outs
    return outs[:3] + [outs[2].detach()] * (n - 4) + outs[3:]
