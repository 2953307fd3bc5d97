"""The port's parameter trees: nested dicts, lists and tuples of tensors.

The reference walks its pytrees with ``jax.tree``; these functions do the
same for the port's trees, in the same leaf order (dict keys sorted,
as JAX sorts them), with each leaf's path written as
``jax.tree_util.keystr`` writes it (``['layers'][0]['attn']['wq']``).
"""
from __future__ import annotations

from typing import Any, Callable


def leaves_with_paths(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """Every leaf of ``tree`` with its path, in a fixed order."""
    if isinstance(tree, dict):
        return [kv for key in sorted(tree) for kv in leaves_with_paths(tree[key], f"{prefix}[{key!r}]")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, sub in enumerate(tree) for kv in leaves_with_paths(sub, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` applied leaf by leaf to ``tree`` and the trees of its
    structure in ``rest``; a tree of the same structure."""
    if isinstance(tree, dict):
        return {key: tree_map(fn, tree[key], *(r[key] for r in rest)) for key in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, sub, *(r[i] for r in rest)) for i, sub in enumerate(tree))
    return fn(tree, *rest)


def tree_unflatten(like: Any, leaves: list[Any]) -> Any:
    """A tree of ``like``'s structure whose leaves, in ``leaves_with_paths``
    order, are ``leaves``."""
    it = iter(leaves)

    def build(tree):
        if isinstance(tree, dict):
            out = {key: build(tree[key]) for key in sorted(tree)}
            return {key: out[key] for key in tree}
        if isinstance(tree, (list, tuple)):
            return type(tree)(build(sub) for sub in tree)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out
