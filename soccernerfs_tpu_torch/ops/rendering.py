"""Volume-rendering compositors (counterpart of soccernerfs_tpu/ops/rendering.py)."""
from __future__ import annotations

from typing import Union

import torch

from soccernerfs_tpu_torch.core.rays import RaySamples
from soccernerfs_tpu_torch.ops.searching import searchsorted_scalar

BACKGROUND_COLORS = {
    "white": (1.0, 1.0, 1.0),
    "black": (0.0, 0.0, 0.0),
}


def render_rgb(
    rgb: torch.Tensor,
    weights: torch.Tensor,
    background_color: Union[str, torch.Tensor] = "last_sample",
) -> torch.Tensor:
    """Composite per-sample RGB along rays as at eval: NaN-scrubbed rgb,
    sum(w * rgb) + bg * (1 - acc), clamped to [0, 1].

    Args:
        rgb: [N, S, 3]; weights: [N, S].
        background_color: "last_sample", "white", "black" or an explicit
            [3] color.  (Training's "random" background comes with
            training.)
    Returns:
        [N, 3].
    """
    rgb = torch.nan_to_num(rgb)
    comp_rgb = torch.sum(weights[..., None] * rgb, dim=-2)
    acc = torch.sum(weights, dim=-1, keepdim=True)

    if isinstance(background_color, str) and background_color == "last_sample":
        bg = rgb[..., -1, :]
    else:
        if isinstance(background_color, str):
            background_color = BACKGROUND_COLORS[background_color]
        bg = torch.as_tensor(background_color, dtype=comp_rgb.dtype,
                             device=comp_rgb.device)
    return torch.clamp(comp_rgb + bg * (1.0 - acc), 0.0, 1.0)


def render_accumulation(weights: torch.Tensor) -> torch.Tensor:
    """Sum of weights per ray, [N]."""
    return torch.sum(weights, dim=-1)


def _median_index(weights: torch.Tensor) -> torch.Tensor:
    cumulative_weights = torch.cumsum(weights, dim=-1)
    median_index = searchsorted_scalar(cumulative_weights, 0.5, side="left")
    return torch.clamp(median_index, 0, weights.shape[-1] - 1).long()


def render_depth(weights: torch.Tensor, ray_samples: RaySamples) -> torch.Tensor:
    """Median depth along each ray, [N]: the bin midpoint where the
    cumulative weight crosses 0.5 (the JAX version's default method)."""
    idx = _median_index(weights)
    return torch.gather(ray_samples.midpoints(), -1, idx[..., None])[..., 0]


def render_median_rgb(rgb: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """RGB at the sample where cumulative weight crosses 0.5.
    [N, S, 3], [N, S] -> [N, 3]."""
    idx = _median_index(weights)
    return torch.gather(rgb, -2, idx[:, None, None].expand(-1, 1, 3))[:, 0, :]
