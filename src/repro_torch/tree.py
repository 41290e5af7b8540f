"""Nested dicts of tensors (parameter, gradient and optimizer-state trees)
taken apart and put together in one fixed order.

The reference's trees are JAX pytrees of dicts, which flatten in sorted
key order; these helpers walk the port's nested dicts in the same order,
so sums over leaves run in the reference's order and a leaf's path (its
keys joined by ``/``) names it as the reference's checkpoints do.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping

import torch

Tree = Any


def is_node(x: Any) -> bool:
    return isinstance(x, Mapping)


def flatten(tree: Tree, prefix: str = "") -> Dict[str, Any]:
    """Path -> leaf, in sorted key order at every level."""
    out: Dict[str, Any] = {}
    for k in sorted(tree):
        path = f"{prefix}/{k}" if prefix else str(k)
        v = tree[k]
        if is_node(v):
            out.update(flatten(v, path))
        else:
            out[path] = v
    return out


def leaves(tree: Tree) -> List[Any]:
    return list(flatten(tree).values())


def unflatten(like: Tree, flat: Mapping[str, Any], prefix: str = "") -> Tree:
    """A tree shaped as `like` whose leaves are ``flat[path]``."""
    out = {}
    for k in like:
        path = f"{prefix}/{k}" if prefix else str(k)
        v = like[k]
        out[k] = unflatten(v, flat, path) if is_node(v) else flat[path]
    return out


def map_tree(fn: Callable[..., Any], tree: Tree, *rest: Tree) -> Tree:
    """fn over the leaves of `tree` and the leaves at the same paths of
    `rest` (trees of the same structure)."""
    return {k: map_tree(fn, v, *(r[k] for r in rest)) if is_node(v)
            else fn(v, *(r[k] for r in rest)) for k, v in tree.items()}


def requires_grad_(tree: Tree, flag: bool = True) -> Tree:
    """Every floating leaf of `tree` made to require grad (in place)."""
    for t in leaves(tree):
        if isinstance(t, torch.Tensor) and t.is_floating_point():
            t.requires_grad_(flag)
    return tree
