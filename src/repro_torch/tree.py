"""Nested-dict trees (the port's params, optimizer and checkpoint trees):
the few traversals the training stack shares.  A leaf is anything that
is not a dict (a tensor, an array, ``None``)."""
from __future__ import annotations

from typing import Any, Callable

PyTree = Any


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    """``fn(leaf, *nodes)`` at every leaf of ``tree``, where ``nodes`` are
    what ``rest`` holds at the same place (a whole subtree where ``tree``
    has a leaf), in ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def leaves(tree: PyTree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    return [tree]


def paths(tree: PyTree, prefix: tuple[str, ...] = ()
          ) -> list[tuple[tuple[str, ...], Any]]:
    """``(path of keys, leaf)`` for every leaf, in order."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in paths(v, (*prefix, k))]
    return [(prefix, tree)]


def map_with_path(fn: Callable, tree: PyTree,
                  prefix: tuple[str, ...] = ()) -> PyTree:
    """``fn(path of keys, leaf)`` at every leaf, in ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, (*prefix, k)) for k, v in tree.items()}
    return fn(prefix, tree)
