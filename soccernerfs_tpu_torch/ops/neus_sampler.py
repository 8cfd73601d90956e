"""NeuS's hierarchical SDF sampler (counterpart of
soccernerfs_tpu/ops/neus_sampler.py).

Uniform samples, then a fixed number of upsampling steps: the SDF at the
bin starts gives alphas under a fixed inverse deviation that doubles each
step, the PDF sampler draws new bins from their weights, and the two sets
merge sorted.  The merged bins carry no gradient, as in the JAX version
(its ``stop_gradient``), so the SDF probes run without a graph.

Randomness is explicit: ``jitters`` holds one stratified draw per
sampling (the uniform one, then one per upsampling step), each [N, 1]
with a single jitter, else [N, S + 1]; None is the eval branch.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from soccernerfs_tpu_torch.core.rays import (
    RayBundle,
    RaySamples,
    get_weights_and_transmittance_from_alphas,
)
from soccernerfs_tpu_torch.ops.samplers import pdf_samples, spaced_samples


def rendering_sdf_with_fixed_inv_s(ray_samples: RaySamples, sdf: torch.Tensor,
                                   inv_s: float) -> torch.Tensor:
    """Alphas [N, S - 1] of the SDF [N, S] at the bin starts under a fixed
    inverse deviation: the section's logistic CDFs at its two ends, the
    slope the smaller of its own and the previous section's, clipped to
    [-1e3, 0]."""
    prev_sdf, next_sdf = sdf[:, :-1], sdf[:, 1:]
    deltas = ray_samples.deltas[:, :-1]
    mid_sdf = (prev_sdf + next_sdf) * 0.5
    cos_val = (next_sdf - prev_sdf) / (deltas + 1e-5)
    prev_cos = torch.cat([torch.zeros_like(cos_val[:, :1]), cos_val[:, :-1]],
                         dim=-1)
    cos_val = torch.clamp(torch.minimum(cos_val, prev_cos), -1e3, 0.0)
    prev_esti = mid_sdf - cos_val * deltas * 0.5
    next_esti = mid_sdf + cos_val * deltas * 0.5
    prev_cdf = torch.sigmoid(prev_esti * inv_s)
    next_cdf = torch.sigmoid(next_esti * inv_s)
    return (prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5)


def merge_ray_samples(ray_bundle: RayBundle, s1: RaySamples, s2: RaySamples
                      ) -> RaySamples:
    """The sorted union of two sample sets' bin starts, closed by the larger
    of their last ends; detached."""
    starts = torch.cat([s1.spacing_starts, s2.spacing_starts], dim=-1)
    bins, _ = torch.sort(starts, dim=-1)
    ends = torch.maximum(s1.spacing_ends[:, -1:], s2.spacing_ends[:, -1:])
    bins = torch.cat([bins, ends], dim=-1).detach()
    merged = ray_bundle.get_ray_samples(
        bin_starts=torch.zeros_like(bins[..., :-1]),
        bin_ends=torch.zeros_like(bins[..., 1:]),
        spacing_starts=bins[..., :-1],
        spacing_ends=bins[..., 1:],
        spacing=s1.spacing,
        s_near=s1.s_near,
        s_far=s1.s_far,
    )
    euclid = merged.spacing_to_euclidean(bins)
    return merged.replace(starts=euclid[..., :-1], ends=euclid[..., 1:])


def neus_sample(
    ray_bundle: RayBundle,
    sdf_fn: Callable[[torch.Tensor], torch.Tensor],
    num_samples: int = 64,
    num_samples_importance: int = 64,
    num_upsample_steps: int = 4,
    base_variance: float = 64.0,
    jitters: Optional[Sequence[torch.Tensor]] = None,
) -> RaySamples:
    """``num_samples`` uniform samples, then ``num_upsample_steps`` steps of
    ``num_samples_importance // num_upsample_steps`` PDF samples each, at
    inverse deviation ``base_variance * 2**step``.

    Args:
        sdf_fn: positions [M, 3] -> sdf [M]; called without a graph.
        jitters: the ``1 + num_upsample_steps`` stratified draws, or None.
    """
    jitters = (list(jitters) if jitters is not None
               else [None] * (num_upsample_steps + 1))
    ray_samples = spaced_samples(ray_bundle, num_samples, "uniform",
                                 jitter=jitters[0])
    per_step = num_samples_importance // num_upsample_steps
    for it in range(num_upsample_steps):
        pos = ray_samples.get_positions()
        n, s = pos.shape[:2]
        with torch.no_grad():
            sdf = sdf_fn(pos.reshape(-1, 3)).reshape(n, s)
        alphas = rendering_sdf_with_fixed_inv_s(ray_samples, sdf,
                                                base_variance * 2**it)
        weights = get_weights_and_transmittance_from_alphas(alphas,
                                                            weights_only=True)
        weights = torch.cat([weights, torch.zeros_like(weights[:, :1])], dim=1)
        new_samples = pdf_samples(ray_bundle, ray_samples, weights, per_step,
                                  jitter=jitters[it + 1],
                                  include_original=False,
                                  histogram_padding=1e-5)
        ray_samples = merge_ray_samples(ray_bundle, ray_samples, new_samples)
    return ray_samples
