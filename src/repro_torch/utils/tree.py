"""Nested-dict trees of tensors, flattened in JAX's order.

The reference keeps parameters as pytrees, and ``jax.tree.flatten`` visits
dict keys in SORTED order, whatever order they were inserted in. The
bucket plan depends on that order (it decides which leaf opens which
bucket), so the port flattens the same way: dicts by sorted key,
everything else a leaf.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


class TreeDef:
    """The shape of a nested dict: ``None`` marks a leaf, a dict maps each
    key to its subtree's TreeDef."""

    def __init__(self, node):
        self._node = node

    def __eq__(self, other) -> bool:
        return isinstance(other, TreeDef) and self._node == other._node

    def __repr__(self) -> str:
        return f"TreeDef({self._node!r})"

    @property
    def num_leaves(self) -> int:
        return _count(self._node)

    def flatten_up_to(self, tree) -> List[Any]:
        """Leaves of ``tree``, which must have this structure."""
        out: List[Any] = []
        _flatten(self._node, tree, out)
        return out

    def unflatten(self, leaves) -> Any:
        leaves = list(leaves)
        if len(leaves) != self.num_leaves:
            raise ValueError(
                f"{len(leaves)} leaves for a tree of {self.num_leaves}")
        it = iter(leaves)
        return _build(self._node, it)


def _structure(tree):
    if isinstance(tree, dict):
        return {k: _structure(tree[k]) for k in sorted(tree)}
    return None


def _count(node) -> int:
    if node is None:
        return 1
    return sum(_count(v) for v in node.values())


def _flatten(node, tree, out: list) -> None:
    if node is None:
        out.append(tree)
        return
    if not isinstance(tree, dict) or set(tree) != set(node):
        raise ValueError("tree does not match the TreeDef's structure")
    for k, sub in node.items():
        _flatten(sub, tree[k], out)


def _build(node, it):
    if node is None:
        return next(it)
    return {k: _build(sub, it) for k, sub in node.items()}


def tree_flatten(tree) -> Tuple[List[Any], TreeDef]:
    treedef = TreeDef(_structure(tree))
    return treedef.flatten_up_to(tree), treedef


def tree_leaves(tree) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable, tree, *rest):
    leaves, treedef = tree_flatten(tree)
    others = [treedef.flatten_up_to(r) for r in rest]
    return treedef.unflatten(fn(*xs) for xs in zip(leaves, *others))
