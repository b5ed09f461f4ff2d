"""Nested dicts of tensors: leaf order and maps.

The reference's trees are JAX pytrees, whose dicts flatten with their keys
sorted; ``flatten`` keeps that order (and names each leaf by its path, the
reference's checkpoint keys), so a sum over ``tree_leaves`` (AdamW's
global norm) adds the leaves as the reference does.  Anything that is not
a dict is a leaf.
"""

from __future__ import annotations

from typing import Any, Callable


def flatten(tree: dict, prefix: str = "") -> dict:
    """A nested dict -> ``{path: leaf}``, paths ``/``-joined with keys
    sorted at every level: the reference's checkpoint keys and leaf order
    (``jax.tree_util.tree_flatten_with_path`` over dicts), the inverse of
    ``convert.unflatten``."""
    out: dict = {}
    for key in sorted(tree):
        node = tree[key]
        if isinstance(node, dict):
            out.update(flatten(node, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = node
    return out


def tree_leaves(tree: Any) -> list:
    """The leaves of a nested dict in ``flatten``'s order."""
    return list(flatten(tree).values()) if isinstance(tree, dict) else [tree]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest``, in ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)
