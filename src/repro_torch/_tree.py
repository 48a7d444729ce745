"""Trees of tensors: nested dicts, lists, tuples and NamedTuples.

The port's stand-in for ``jax.tree_util`` over parameter and optimizer
trees: :func:`tree_map` keeps a tree's structure, :func:`leaves` lists its
leaves in jax's flattening order (dict keys sorted), and ``None`` holds no
leaf.
"""
from __future__ import annotations

from typing import Any, Callable, List


def is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of each
    tree in ``rest``, which share its structure)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        return type(tree)(*out) if is_namedtuple(tree) else type(tree)(out)
    return fn(tree, *rest)


def leaves(tree) -> List[Any]:
    """The leaves of ``tree``, dict keys in sorted order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def unflatten(tree, values) -> Any:
    """A tree shaped like ``tree`` holding ``values`` in :func:`leaves`
    order (the inverse of ``leaves``); dicts keep ``tree``'s key order."""
    it = iter(values)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            out = {k: build(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}
        if isinstance(node, (list, tuple)):
            out = [build(v) for v in node]
            return type(node)(*out) if is_namedtuple(node) else type(node)(out)
        return next(it)

    return build(tree)
