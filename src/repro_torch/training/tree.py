"""Nested dicts / lists / tuples of tensors as trees (the port's pytrees).

Dict children are visited in sorted key order (as ``jax.tree`` does),
list and tuple children in order; a NamedTuple keeps its type.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _children(tree):
    if isinstance(tree, dict):
        return [tree[k] for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return list(tree)
    return None


def _rebuild(tree, children: list):
    if isinstance(tree, dict):
        return dict(zip(sorted(tree), children))
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*children)
    return type(tree)(children)


def leaves_with_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """[(path, leaf)] in tree order; paths join keys/indices with '/'."""
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    names = (sorted(tree) if isinstance(tree, dict)
             else tree._fields if hasattr(tree, "_fields")
             else range(len(kids)))
    out = []
    for name, kid in zip(names, kids):
        out.extend(leaves_with_paths(kid, f"{prefix}/{name}"))
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def unflatten(template, new_leaves: list):
    """A tree shaped like ``template`` holding ``new_leaves`` in order."""
    it = iter(new_leaves)

    def build(t):
        kids = _children(t)
        if kids is None:
            return next(it)
        return _rebuild(t, [build(k) for k in kids])

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template has")
    return out


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over corresponding leaves of trees of one structure."""
    flat = [leaves(t) for t in (tree, *rest)]
    return unflatten(tree, [fn(*xs) for xs in zip(*flat)])
