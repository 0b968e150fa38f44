"""Params trees: nested dicts of tensors, walked in JAX's tree_flatten order
(keys sorted at every level), so the port's leaf order is the reference's.
A tensor that is not in a dict is a one-leaf tree."""
from __future__ import annotations


def leaves_with_paths(tree, prefix=()):
    """(path, leaf) pairs in leaf order: for the MLP l1.b, l1.w, l2.b,
    l2.w, l3.b, l3.w."""
    if isinstance(tree, dict):
        out = []
        for key in sorted(tree):
            out.extend(leaves_with_paths(tree[key], prefix + (key,)))
        return out
    return [(prefix, tree)]


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in leaf order."""
    return [leaf for _, leaf in leaves_with_paths(tree)]


def leaf2d(x):
    """A client-stacked (K, ...) leaf as a (K, prod(trailing)) plane; a
    (K, D) plane as it is."""
    return x if x.dim() == 2 else x.reshape(x.shape[0], -1)


def tree_map(fn, tree, *rest):
    """Map over the leaves of trees of one structure."""
    if isinstance(tree, dict):
        return {key: tree_map(fn, tree[key], *(r[key] for r in rest))
                for key in tree}
    return fn(tree, *rest)


def build(paths, values) -> dict:
    """The nested dict holding ``values`` at ``paths``."""
    tree: dict = {}
    for path, v in zip(paths, values):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = v
    return tree
