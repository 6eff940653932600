"""Nested parameter trees: the port's stand-in for JAX pytrees.

A tree is nested dicts and lists (a JAX pytree's ``prefix`` list of
unrolled layers) whose leaves are tensors or packed
:class:`~repro_torch.core.lns.LNSWeight` s. Paths are tuples of dict keys
and list indices, in insertion order.
"""
from __future__ import annotations

from typing import Callable, Iterator, Tuple

__all__ = ["leaves", "tree_get", "tree_set", "tree_map"]


def leaves(tree, path: Tuple = ()) -> Iterator:
    """``(path, leaf)`` over nested dicts and lists."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from leaves(v, path + (i,))
    else:
        yield path, tree


def tree_get(tree, path: Tuple):
    for k in path:
        tree = tree[k]
    return tree


def _child(node, key, nxt):
    """``node[key]``, made (a list before an int key, else a dict) if
    it is missing."""
    if isinstance(node, list):
        node.extend([None] * (key + 1 - len(node)))
        if node[key] is None:
            node[key] = [] if isinstance(nxt, int) else {}
        return node[key]
    return node.setdefault(key, [] if isinstance(nxt, int) else {})


def tree_set(tree, path: Tuple, value) -> None:
    for k, nxt in zip(path[:-1], path[1:]):
        tree = _child(tree, k, nxt)
    if isinstance(tree, list):
        tree.extend([None] * (path[-1] + 1 - len(tree)))
    tree[path[-1]] = value


def tree_map(fn: Callable, tree, *rest):
    """The tree of ``fn(leaf, *leaves of rest at the same path)``, shaped
    like ``tree``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)
