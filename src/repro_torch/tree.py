"""Nested dicts of tensors, the port's counterpart of the reference's
pytrees of parameters, gradients and optimizer state.  Trees are matched by
key, not by position, so two dicts built in another key order still pair
up."""
from __future__ import annotations

from typing import Callable, List, Tuple


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


def tree_items(tree, path: str = "") -> List[Tuple[str, object]]:
    """(path, leaf) pairs in the tree's key order, each path spelt as
    ``jax.tree_util.keystr`` spells a dict path (``['opt']['m']['w']``)."""
    if isinstance(tree, dict):
        return [item for k, v in tree.items()
                for item in tree_items(v, f"{path}[{k!r}]")]
    return [(path, tree)]


def tree_map_with_path(fn: Callable, tree, path: str = ""):
    """``fn(path, leaf)`` over the leaves of ``tree``, paths as in
    `tree_items`."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, f"{path}[{k!r}]")
                for k, v in tree.items()}
    return fn(path, tree)
