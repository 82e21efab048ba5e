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


def keystr(path) -> str:
    """JAX's tree_util.keystr for a path of dict keys (str) and list
    indices (int): the key of a leaf in the JAX trainer's checkpoints."""
    return "".join(f"[{p}]" if isinstance(p, int) else f"[{p!r}]"
                   for p in path)


def leaves_with_paths(tree, path=()):
    """(path, leaf) of every leaf, in `tree_leaves` order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves_with_paths(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves_with_paths(v, path + (i,))
    else:
        yield path, tree


def map_with_paths(fn, tree, path=()):
    """`tree` with every leaf replaced by fn(path, leaf) (lists for
    sequences)."""
    if isinstance(tree, dict):
        return {k: map_with_paths(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_with_paths(fn, v, path + (i,))
                for i, v in enumerate(tree)]
    return fn(path, tree)
