"""Row-wise searchsorted (counterpart of soccernerfs_tpu/ops/searching.py).

The JAX version counts comparisons because a vectorised binary search
compiles badly for the TPU; PyTorch has a batched binary search, which
gives the same indices for row-wise sorted sequences.
"""
from __future__ import annotations

import torch


def searchsorted(
    sorted_seq: torch.Tensor, values: torch.Tensor, side: str = "left"
) -> torch.Tensor:
    """For each batch row, the insertion indices of ``values`` into
    ``sorted_seq``.

    Args:
        sorted_seq: [..., K] row-wise sorted.
        values: [..., Q].
    Returns:
        [..., Q] int32 indices in [0, K].
    """
    return torch.searchsorted(
        sorted_seq.contiguous(), values.contiguous(), right=side == "right"
    ).to(torch.int32)


def searchsorted_scalar(
    sorted_seq: torch.Tensor, value: float, side: str = "left"
) -> torch.Tensor:
    """[..., K] vs a scalar query -> [...] int32 indices."""
    cmp = sorted_seq <= value if side == "right" else sorted_seq < value
    return torch.sum(cmp, dim=-1, dtype=torch.int32)
