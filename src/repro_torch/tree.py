"""Nested parameter containers (dicts, lists, tuples of tensors; ``None``
is an empty subtree), the port's stand-in for JAX pytrees.  Dict keys are
walked in sorted order, as ``jax.tree`` walks them, so sums over leaves
add in the JAX package's order."""
from __future__ import annotations

__all__ = ["tree_leaves", "tree_map", "tree_unflatten"]


def tree_leaves(tree) -> list:
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_unflatten(like, leaves):
    """A tree shaped like ``like`` over ``leaves`` (in ``tree_leaves``
    order)."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        return next(it)

    return build(like)


def tree_map(fn, tree, *rest):
    """``fn`` over corresponding leaves of trees of one structure."""
    cols = zip(tree_leaves(tree), *(tree_leaves(t) for t in rest))
    return tree_unflatten(tree, [fn(*c) for c in cols])
