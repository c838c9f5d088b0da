"""Nested containers of tensors ("trees"): the port's stand-in for
``jax.tree_util`` in the training substrate.

A tree is a dict, list, tuple or NamedTuple of trees, or a leaf (a tensor,
a number, an array).  ``None`` is an empty tree with no leaf, as in JAX.
Leaves are visited in JAX's order: dict keys sorted, sequences and
NamedTuple fields in order, so the leaf paths of :func:`leaf_paths` are
the reference checkpointer's keys.
"""
from __future__ import annotations

from typing import Any, Callable


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _children(node) -> list[tuple[Any, Any]] | None:
    """(key, child) pairs of a container in visiting order; None for a
    leaf."""
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return list(zip(node._fields, node))
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    return None


def leaf_paths(tree, prefix: tuple = ()) -> list[tuple[tuple, Any]]:
    """Every leaf with its path (the keys, indices and field names from
    the root), in visiting order."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for k, child in kids:
        out += leaf_paths(child, prefix + (k,))
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in leaf_paths(tree)]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` applied leaf by leaf to ``tree`` and the trees of the same
    structure in ``rest``; the result has ``tree``'s structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*(
            tree_map(fn, t, *(r[i] for r in rest)) for i, t in enumerate(tree)
        ))
    if isinstance(tree, (list, tuple)):
        return type(tree)(
            tree_map(fn, t, *(r[i] for r in rest)) for i, t in enumerate(tree)
        )
    return fn(tree, *rest)


def unflatten(like, new_leaves) -> Any:
    """A tree of ``like``'s structure holding ``new_leaves`` in visiting
    order (the inverse of :func:`leaves`)."""
    it = iter(new_leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            out = {k: build(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}
        if _is_namedtuple(node):
            return type(node)(*(build(t) for t in node))
        if isinstance(node, (list, tuple)):
            return type(node)(build(t) for t in node)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out
