"""Nested containers of tensors ("trees"), as the reference's pytrees.

A tree is a dict (keys visited in sorted order, as ``jax.tree`` does), a
list, a tuple or ``None`` (an empty node); anything else is a leaf.  The
port needs only these, so it keeps this small copy instead of torch's
private ``torch.utils._pytree``.
"""
from __future__ import annotations

from typing import Any, Callable


def tree_leaves(tree, prefix=()):
    """(path, leaf) pairs of ``tree`` in order: a path is the dict keys
    and list/tuple positions from the root to the leaf."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from tree_leaves(t, prefix + (i,))
    elif tree is not None:
        yield prefix, tree


def leaves(tree) -> list:
    """The leaves of ``tree`` in order."""
    return [x for _, x in tree_leaves(tree)]


def structure(tree):
    """A hashable description of ``tree``'s nodes (leaves as ``"*"``)."""
    if isinstance(tree, dict):
        return ("dict", tuple((k, structure(tree[k])) for k in sorted(tree)))
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__, tuple(structure(t) for t in tree))
    return None if tree is None else "*"


def unflatten(like, flat) -> Any:
    """A tree of ``like``'s structure holding the values of ``flat``, in
    :func:`leaves` order."""
    it = iter(flat)
    out = _rebuild(like, it)
    if next(it, _END) is not _END:
        raise ValueError("more values than leaves")
    return out


_END = object()


def _rebuild(like, it):
    if isinstance(like, dict):
        return {k: _rebuild(like[k], it) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(t, it) for t in like)
    if like is None:
        return None
    return next(it)


def map_tree(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of the
    trees in ``rest``, which share its structure)."""
    if not rest:
        return unflatten(tree, [fn(x) for x in leaves(tree)])
    for r in rest:
        if structure(r) != structure(tree):
            raise ValueError("trees of different structure")
    return unflatten(tree, [fn(*xs) for xs in zip(leaves(tree), *map(leaves, rest))])


def broadcast_prefix(prefix, tree, is_leaf: Callable[[Any], bool]) -> list:
    """One entry of ``prefix`` per leaf of ``tree``: ``prefix`` is a tree
    whose structure is a prefix of ``tree``'s, and an entry at an interior
    position (``is_leaf(entry)``) applies to every leaf below it."""
    if is_leaf(prefix):
        return [prefix] * len(leaves(tree))
    if isinstance(prefix, dict) and isinstance(tree, dict) and set(prefix) == set(tree):
        return [x for k in sorted(tree) for x in broadcast_prefix(prefix[k], tree[k], is_leaf)]
    if (isinstance(prefix, (list, tuple)) and isinstance(tree, (list, tuple))
            and len(prefix) == len(tree)):
        return [x for p, t in zip(prefix, tree) for x in broadcast_prefix(p, t, is_leaf)]
    raise ValueError(f"spec {prefix!r} is not a prefix of the output structure "
                     f"{structure(tree)!r}")
