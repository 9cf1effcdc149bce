"""Leaves of the port's state trees in one fixed order, and the tree
rebuilt from them: the part of ``jax.tree_util`` that training needs.

A tree is a dict (its keys taken in sorted order, as JAX takes them), a
list, a tuple or a NamedTuple (fields in order) of trees; ``None`` holds
no leaf; anything else is a leaf (a tensor, a number). The parameter trees
of ``models/``, the optimizer states of ``optimizer.py`` and the pair
(params, state) the trainer checkpoints are such trees.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List


def _iter(tree) -> Iterator[Any]:
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _iter(tree[key])
    elif isinstance(tree, (list, tuple)):
        for sub in tree:
            yield from _iter(sub)
    elif tree is not None:
        yield tree


def leaves(tree) -> List[Any]:
    """The leaves of ``tree`` in their fixed order."""
    return list(_iter(tree))


def unflatten(like, new_leaves) -> Any:
    """A tree shaped like ``like`` whose leaves are ``new_leaves`` (in the
    order ``leaves(like)`` gives)."""
    it = iter(new_leaves)

    def build(node):
        if isinstance(node, dict):
            built = {key: build(node[key]) for key in sorted(node)}
            return {key: built[key] for key in node}   # like's key order
        if isinstance(node, list):
            return [build(sub) for sub in node]
        if isinstance(node, tuple):
            subs = [build(sub) for sub in node]
            return type(node)(*subs) if hasattr(node, "_fields") \
                else tuple(subs)
        return None if node is None else next(it)
    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def stack_keys(tree) -> List[tuple]:
    """For each leaf, its path with the list indices left out: the leaves
    of one key share a tensor in ``repro``'s layout, which stacks a list's
    elements (the layers, a hybrid's periods and sublayers) on a leading
    axis."""
    out: List[tuple] = []

    def walk(node, path):
        if isinstance(node, dict):
            for key in sorted(node):
                walk(node[key], path + (key,))
        elif isinstance(node, list):
            for sub in node:
                walk(sub, path)
        elif isinstance(node, tuple):
            for i, sub in enumerate(node):
                walk(sub, path + (i,))
        elif node is not None:
            out.append(path)
    walk(tree, ())
    return out


def map_tree(fn: Callable[[Any], Any], tree) -> Any:
    """``fn`` applied to every leaf of ``tree``."""
    return unflatten(tree, [fn(x) for x in leaves(tree)])


def structure(tree) -> str:
    """A readable form of the tree's nodes, leaves written ``*``."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {structure(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, list):
        return "[" + ", ".join(structure(s) for s in tree) + "]"
    if isinstance(tree, tuple):
        name = type(tree).__name__ if hasattr(tree, "_fields") else ""
        return name + "(" + ", ".join(structure(s) for s in tree) + ")"
    return "None" if tree is None else "*"
