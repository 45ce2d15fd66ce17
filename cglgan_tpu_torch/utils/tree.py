"""Minimal pytree helpers for the port's parameter containers.

Parameters, BN buffers and Adam moments are nested lists/tuples/dicts of
stacked tensors with ``None`` holes, exactly the reference's layout (an MLP
param list is ``[{w, b}, None, {scale, bias}, None, ...]``).  These helpers
walk that structure; ``None`` leaves stay ``None``.  Dict keys are walked
in sorted order, as ``jax.tree`` does, so leaf lists line up with the
reference's.
"""
from __future__ import annotations

from typing import Any, Callable, List


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leafwise over trees of identical structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        out = [tree_map(fn, t, *(r[i] for r in rest))
               for i, t in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[Any]:
    out: List[Any] = []
    tree_map(out.append, tree)
    return out


def tree_unflatten(like: Any, leaves: List[Any]) -> Any:
    """Rebuild ``like``'s structure from ``leaves`` in ``tree_leaves`` order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)
