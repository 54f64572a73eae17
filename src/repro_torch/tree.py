"""Nested containers of tensors, flattened in ``jax.tree_util``'s order.

A tree is a dict (keys in sorted order), a NamedTuple such as
``OptState`` (fields in order), a tuple or list (in order), or a leaf.
The order is the reference's, so a checkpoint's leaf files line up with
the reference's trees one for one.
"""
from __future__ import annotations

from typing import Any, Callable, List


def _children(tree):
    if isinstance(tree, dict):
        return [tree[k] for k in sorted(tree)]
    if isinstance(tree, (tuple, list)):
        return list(tree)
    return None


def leaves(tree) -> List[Any]:
    """Every leaf of ``tree``, depth first."""
    kids = _children(tree)
    if kids is None:
        return [tree]
    return [leaf for kid in kids for leaf in leaves(kid)]


def unflatten(like, values) -> Any:
    """A tree shaped like ``like`` whose leaves are ``values`` in order."""
    it = iter(values)
    out = _rebuild(like, it)
    if next(it, None) is not None:
        raise ValueError("more values than leaves")
    return out


def _rebuild(like, it):
    if isinstance(like, dict):
        return {k: _rebuild(like[k], it) for k in sorted(like)}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_rebuild(v, it) for v in like))
    if isinstance(like, (tuple, list)):
        return type(like)(_rebuild(v, it) for v in like)
    try:
        return next(it)
    except StopIteration:
        raise ValueError("fewer values than leaves") from None


def map_tree(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest``, which share its structure."""
    others = [leaves(r) for r in rest]
    return unflatten(tree, [fn(*args) for args in
                            zip(leaves(tree), *others)])
