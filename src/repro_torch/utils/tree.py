"""Trees of nested dicts and lists of tensors, flattened in JAX's order.

The reference keeps parameters as pytrees, and ``jax.tree.flatten`` visits
dict keys in SORTED order, whatever order they were inserted in, and list
items by index. The bucket plan depends on that order (it decides which
leaf opens which bucket), so the port flattens the same way: dicts by
sorted key, lists by index (griffin's per-layer blocks), everything else
a leaf.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


class TreeDef:
    """The shape of a tree: ``None`` marks a leaf, a dict maps each key to
    its subtree's node, a list holds its items' nodes in order."""

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
    if isinstance(tree, list):
        return [_structure(x) for x in tree]
    return None


def _count(node) -> int:
    if node is None:
        return 1
    subs = node.values() if isinstance(node, dict) else node
    return sum(_count(v) for v in subs)


def _flatten(node, tree, out: list) -> None:
    if node is None:
        out.append(tree)
        return
    if isinstance(node, list):
        if not isinstance(tree, list) or len(tree) != len(node):
            raise ValueError("tree does not match the TreeDef's structure")
        for sub, x in zip(node, tree):
            _flatten(sub, x, out)
        return
    if not isinstance(tree, dict) or set(tree) != set(node):
        raise ValueError("tree does not match the TreeDef's structure")
    for k, sub in node.items():
        _flatten(sub, tree[k], out)


def _build(node, it):
    if node is None:
        return next(it)
    if isinstance(node, list):
        return [_build(sub, it) for sub in node]
    return {k: _build(sub, it) for k, sub in node.items()}


def _key_paths(node, prefix: tuple, out: list) -> None:
    if node is None:
        out.append(prefix)
        return
    items = node.items() if isinstance(node, dict) else enumerate(node)
    for k, sub in items:
        _key_paths(sub, prefix + (k,), out)


def tree_paths(tree) -> List[tuple]:
    """Each leaf's key path (dict keys and list indices), in
    ``tree_flatten`` order."""
    out: List[tuple] = []
    _key_paths(_structure(tree), (), out)
    return out


def tree_flatten(tree) -> Tuple[List[Any], TreeDef]:
    treedef = TreeDef(_structure(tree))
    return treedef.flatten_up_to(tree), treedef


def tree_leaves(tree) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable, tree, *rest):
    leaves, treedef = tree_flatten(tree)
    others = [treedef.flatten_up_to(r) for r in rest]
    return treedef.unflatten(fn(*xs) for xs in zip(leaves, *others))
