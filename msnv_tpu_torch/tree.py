"""Parameter trees: nested dicts / lists with tensors at the leaves."""

from __future__ import annotations


def tree_leaves(tree) -> list:
    """The leaves of a nested dict / list tree, in a fixed order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    """Apply fn leaf-wise over trees of one structure (visiting the leaves
    in `tree_leaves` order)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)
