"""Pytrees of nested dicts and lists with tensor leaves, flattened as
``jax.tree_util`` flattens them: dict keys in sorted order, list entries
in order. The optimizer walks params, gradients and moments leaf by leaf
in this order, and the checkpoint manager writes leaves in it."""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

PyTree = Any


def _items(tree):
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    return [(str(i), v) for i, v in enumerate(tree)]


def is_node(tree) -> bool:
    return isinstance(tree, (dict, list, tuple))


def paths(tree: PyTree, prefix: Tuple[str, ...] = ()
          ) -> List[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) pairs in flattening order; a path is the tuple of
    keys and list indices (as strings) from the root."""
    if not is_node(tree):
        return [(prefix, tree)]
    return [pl for k, v in _items(tree) for pl in paths(v, prefix + (k,))]


def leaves(tree: PyTree) -> List[Any]:
    return [leaf for _, leaf in paths(tree)]


def map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), in a tree of the same structure."""
    if isinstance(tree, dict):
        return {k: map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def unflatten(target: PyTree, new_leaves: List[Any]) -> PyTree:
    """A tree of ``target``'s structure holding ``new_leaves`` in
    flattening order."""
    new_leaves = list(new_leaves)
    n = len(leaves(target))
    if len(new_leaves) != n:
        raise ValueError(f"{len(new_leaves)} leaves for a tree of {n}")
    it = iter(new_leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)([build(v) for v in node])
        return next(it)

    return build(target)
