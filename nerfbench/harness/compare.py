"""The numbers compared with the reference, each taken by its worst part."""
from __future__ import annotations

import statistics
from typing import Dict, Iterable, List, Optional, Tuple

import torch


def named_leaves(tree, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """[(path, leaf)] depth first, dicts in insertion order: the program's
    leaf order."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in named_leaves(v, f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in named_leaves(v, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def norms(pairs: Iterable[Tuple[str, torch.Tensor]]) -> Dict[str, float]:
    """{path: L2 norm} in f64, read in one transfer."""
    pairs = list(pairs)
    values = torch.stack([t.detach().double().norm() for _p, t in pairs]).cpu().tolist()
    return {p: v for (p, _t), v in zip(pairs, values)}


def worst_leaf_gap(program: Dict[str, float], reference: Dict[str, float],
                   leaves: Optional[Iterable[str]] = None) -> Tuple[float, str]:
    """The largest gap between a leaf's norm in the program and in the
    reference, over the larger of that leaf's reference norm and the
    median leaf's; and the leaf."""
    med = statistics.median(reference.values())
    worst, where = 0.0, ""
    for path in (reference if leaves is None else leaves):
        gap = abs(program[path] - reference[path]) / max(reference[path], med)
        if gap != gap:
            return float("nan"), path
        if gap > worst or where == "":
            worst, where = gap, path
    return worst, where


def relative_gap(program: float, reference: float) -> float:
    return abs(program - reference) / abs(reference)
