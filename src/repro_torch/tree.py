"""Nested dicts of tensors, the port's counterpart of the reference's
pytrees of parameters, gradients and optimizer state.  Trees are matched by
key, not by position, so two dicts built in another key order still pair
up."""
from __future__ import annotations

from typing import Callable, List


def tree_map(fn: Callable, *trees):
    """``fn`` over the leaves of ``trees[0]``, each called with the matching
    subtrees of the other trees (which may go deeper, as a quantized moment
    ``{"q", "scale"}`` does under a parameter's key)."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def tree_leaves(tree) -> List:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]
