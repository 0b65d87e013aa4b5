"""Nested params trees of the port: dicts (and lists of per-layer views)
with tensors at the leaves, walked in the reference's ``jax.tree`` order
(dict keys sorted, list items in order)."""
from __future__ import annotations


def tree_leaves(tree):
    """The leaves of ``tree``, dict keys in sorted order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of the same-shaped ``rest``,
    into a tree of ``tree``'s structure, called in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_items(tree, prefix: str = ""):
    """(key path, leaf) pairs of ``tree`` in ``tree_leaves`` order, the
    path's parts joined by "/"."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in tree_items(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [x for i, t in enumerate(tree)
                for x in tree_items(t, f"{prefix}{i}/")]
    return [(prefix.rstrip("/"), tree)]


def tree_unflatten(tree, leaves):
    """A tree of ``tree``'s structure whose leaves are ``leaves``, taken in
    ``tree_leaves`` order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)
