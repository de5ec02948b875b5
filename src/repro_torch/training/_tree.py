"""The pytree rules the training modules share with the JAX package.

Trees are nested dicts (and lists or tuples) of tensors.  A dict's leaves
come in sorted key order, as ``jax.tree_util`` flattens it, so the
optimizer's global norm sums leaves in the reference's order and a
checkpoint's ``leaf_i`` is the reference's i-th leaf.
"""
from __future__ import annotations

from typing import Any, Callable, List

PyTree = Any


def _children(tree):
    if isinstance(tree, dict):
        return [tree[k] for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return list(tree)
    return None


def leaves(tree: PyTree) -> List[Any]:
    """The leaves in JAX's flatten order (``None`` holds no leaf)."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [tree]
    return [x for kid in kids for x in leaves(kid)]


def unflatten(like: PyTree, flat) -> PyTree:
    """``like``'s structure with ``flat`` (in :func:`leaves`' order) as
    its leaves."""
    it = iter(flat)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}  # keep the caller's key order
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    others = [leaves(r) for r in rest]
    return unflatten(tree, [fn(x, *ys) for x, *ys in
                            zip(leaves(tree), *others)])


def treedef_str(tree: PyTree) -> str:
    """``str(jax.tree_util.tree_structure(tree))`` for dicts, lists,
    tuples and leaves: the manifest's ``treedef``."""
    def show(t):
        if t is None:
            return "None"
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {show(t[k])}"
                                   for k in sorted(t)) + "}"
        if isinstance(t, list):
            return "[" + ", ".join(show(x) for x in t) + "]"
        if isinstance(t, tuple):
            inner = ", ".join(show(x) for x in t)
            return f"({inner},)" if len(t) == 1 else f"({inner})"
        return "*"

    return f"PyTreeDef({show(tree)})"
