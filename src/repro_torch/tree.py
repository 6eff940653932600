"""Nested-dict parameter trees: the port's stand-in for JAX pytrees.

A tree is nested dicts whose leaves are tensors or packed
:class:`~repro_torch.core.lns.LNSWeight` s. Paths are tuples of keys, in
insertion order.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterator, Tuple

__all__ = ["leaves", "tree_get", "tree_set", "tree_map"]


def leaves(tree, path: Tuple[str, ...] = ()) -> Iterator:
    """``(path, leaf)`` over a nested dict."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, path + (k,))
    else:
        yield path, tree


def tree_get(tree, path: Tuple[str, ...]):
    for k in path:
        tree = tree[k]
    return tree


def tree_set(tree: Dict, path: Tuple[str, ...], value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def tree_map(fn: Callable, tree, *rest) -> Dict:
    """The tree of ``fn(leaf, *leaves of rest at the same path)``, shaped
    like ``tree``."""
    out: Dict = {}
    for path, leaf in leaves(tree):
        tree_set(out, path, fn(leaf, *(tree_get(r, path) for r in rest)))
    return out
