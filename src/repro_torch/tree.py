"""Nested dicts of tensors (parameter, optimizer and train-state trees)
walked in JAX's flatten order.

`jax.tree_util` flattens a dict in the order of its sorted keys, where a
Python dict iterates in insertion order.  Sums over leaves (the global
gradient norm) and the leaf files of a checkpoint follow the flatten
order, so the port walks its trees the same way: `leaves` and
`flatten_with_paths` sort keys at every level, and a path is the string
`jax.tree_util.tree_flatten_with_path` gives (``['params']/['embed']``;
a bare leaf's path is ``""``).
"""

from __future__ import annotations

from typing import Any, Callable


def _is_node(x) -> bool:
    return isinstance(x, dict)


def leaves(tree) -> list:
    """The leaves of ``tree`` in JAX's flatten order."""
    if _is_node(tree):
        return [leaf for k in sorted(tree) for leaf in leaves(tree[k])]
    return [tree]


def flatten_with_paths(tree) -> tuple[list[str], list]:
    """``(keys, leaves)`` in JAX's flatten order; each key the path
    string of `jax.tree_util.tree_flatten_with_path`."""
    keys, out = [], []

    def walk(node, path):
        if _is_node(node):
            for k in sorted(node):
                walk(node[k], path + [f"[{k!r}]"])
        else:
            keys.append("/".join(path))
            out.append(node)

    walk(tree, [])
    return keys, out


def unflatten_like(like, new_leaves: list):
    """A tree of ``like``'s structure holding ``new_leaves`` (in flatten
    order)."""
    it = iter(new_leaves)

    def build(node):
        if _is_node(node):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}     # keep like's key order
        return next(it)

    return build(like)


def map_structure(fn: Callable[..., Any], tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure, or with ``tree``'s leaves as
    their subtrees' roots: an int8 moment ``{"q", "scale"}`` stands where
    a parameter leaf stands)."""
    if _is_node(tree):
        return {k: map_structure(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)
