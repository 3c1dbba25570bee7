"""Trees of tensors: the port's parameters and optimizer state are nested
dicts and lists (``params["layers"][3]["attn"]["wq"]``) where the
reference has JAX pytrees.  A leaf's path joins its keys and list indices
with "/" (``layers/3/attn/wq``), the checkpoint's keys.  Dict keys are
walked in sorted order, as ``jax.tree`` walks them."""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Callable

SEP = "/"


def _children(tree) -> list[tuple[str, Any]] | None:
    if isinstance(tree, Mapping):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return [(str(i), t) for i, t in enumerate(tree)]
    return None


def leaves_with_paths(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """Every leaf with its path, depth first."""
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for key, sub in kids:
        out += leaves_with_paths(sub, f"{prefix}{SEP}{key}" if prefix else key)
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def unflatten(like, flat: list):
    """A tree shaped like ``like`` holding ``flat`` (in ``leaves`` order)."""
    it = iter(flat)

    def build(tree):
        kids = _children(tree)
        if kids is None:
            return next(it)
        if isinstance(tree, Mapping):
            return {k: build(tree[k]) for k in sorted(tree)}
        return type(tree)(build(t) for t in tree)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out
