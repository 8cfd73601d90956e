"""Nested dicts and lists of tensors (the port's parameter trees)."""
from __future__ import annotations

from typing import List


def tree_leaves(tree) -> List:
    """The leaves, depth first, dicts in insertion order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]
