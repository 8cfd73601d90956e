"""Volume-rendering compositors (counterpart of soccernerfs_tpu/ops/rendering.py)."""
from __future__ import annotations

from typing import Optional, Union

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
    train: bool = False,
) -> torch.Tensor:
    """Composite per-sample RGB along rays: sum(w * rgb) + bg * (1 - acc).
    Outside training rgb is NaN-scrubbed first and the result clamped to
    [0, 1]; in training neither (gradients see the raw values).

    Args:
        rgb: [N, S, 3]; weights: [N, S].
        background_color: "last_sample", "white", "black", or an explicit
            [3] or [N, 3] color (training's "random" background is an
            explicit [N, 3] uniform draw made by the caller).
    Returns:
        [N, 3].
    """
    if not train:
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
    comp_rgb = comp_rgb + bg * (1.0 - acc)
    return comp_rgb if train else torch.clamp(comp_rgb, 0.0, 1.0)


def random_background(num_rays: int, device,
                      generator: Optional[torch.Generator] = None
                      ) -> torch.Tensor:
    """The "random" background: [N, 3] uniform draws from ``generator``.
    Without one (outside training) it draws from a generator seeded with 0,
    so that a whole-image render is deterministic, as the JAX package's is
    with its fixed ``PRNGKey(0)`` there: the same distribution, other
    values (torch cannot reproduce JAX's stream; tests hand both sides the
    same draws)."""
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    return torch.rand((num_rays, 3), generator=generator, device=device)


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


def render_semantics(semantics: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Semantic logits composited along rays: sum(w * logits).
    [N, S, C], [N, S] -> [N, C]."""
    return torch.sum(weights[..., None] * semantics, dim=-2)


def render_normals(normals: torch.Tensor, weights: torch.Tensor,
                   normalize: bool = True) -> torch.Tensor:
    """Normals composited along rays, sum(w * n), then scaled to unit
    length (+ 1e-10) unless ``normalize`` is False.  [N, S, 3], [N, S] ->
    [N, 3]."""
    n = torch.sum(weights[..., None] * normals, dim=-2)
    if normalize:
        n = n / (torch.linalg.norm(n, dim=-1, keepdim=True) + 1e-10)
    return n


def render_decomposition(probs: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """NeRFPlayer's static / deforming / new probabilities composited along
    rays: sum(w * probs).  [N, S, 3], [N, S] -> [N, 3]."""
    return torch.sum(weights[..., None] * probs, dim=-2)
