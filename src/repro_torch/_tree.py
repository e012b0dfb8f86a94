"""Nested dicts, lists and tuples of tensors as the port's pytrees.

Leaf order and ``a/b/0`` leaf paths are those of the port's equivalence
flattener (``core/equivalence.py``), which are the reference's
``jax.tree_util`` order and paths for such trees (dict keys sorted).
"""
from __future__ import annotations

from typing import Any, Callable, Iterable, List, Tuple

from repro_torch.core.equivalence import _flatten_with_path


def leaves(tree: Any) -> List[Any]:
    return [x for _, x in _flatten_with_path(tree)]


def paths(tree: Any) -> List[Tuple[str, Any]]:
    """``[("a/b/0", leaf), ...]`` in leaf order."""
    return [("/".join(p), x) for p, x in _flatten_with_path(tree)]


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def unflatten(like: Any, values: Iterable[Any]) -> Any:
    """The structure of ``like`` with its leaves replaced, in leaf order,
    by ``values``."""
    it = iter(values)

    def walk(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return next(it)

    return walk(like)
