"""Ray samplers (counterpart of soccernerfs_tpu/ops/samplers.py).

Randomness enters only as explicit uniform draws (``jitter``): a caller
that trains makes them with its own ``torch.Generator``, and a test hands
both packages the same numbers.  Without draws a sampler is deterministic
(the eval branch, ``stratified=False`` in the JAX version).
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch

from soccernerfs_tpu_torch.core.rays import RayBundle, RaySamples, spacing_fn
from soccernerfs_tpu_torch.ops.searching import searchsorted


def spaced_samples(
    ray_bundle: RayBundle,
    num_samples: int,
    spacing: str = "uniform",
    jitter: Optional[torch.Tensor] = None,
) -> RaySamples:
    """Sample bins between nears/fars under a spacing warp.

    Args:
        ray_bundle: rays with ``nears``/``fars`` set.
        num_samples: S; produces S bins from S+1 edges.
        spacing: one of uniform|lindisp|sqrt|log|piecewise.
        jitter: optional uniform draws in [0, 1), [N, 1] (one per ray) or
            [N, S+1]; when given, bin edges move between bin centers
            (stratified sampling).
    """
    assert ray_bundle.nears is not None and ray_bundle.fars is not None
    num_rays = ray_bundle.num_rays
    dev = ray_bundle.origins.device
    bins = torch.linspace(0.0, 1.0, num_samples + 1, device=dev)[None, :]

    if jitter is not None:
        bin_centers = (bins[..., 1:] + bins[..., :-1]) / 2.0
        bin_upper = torch.cat([bin_centers, bins[..., -1:]], dim=-1)
        bin_lower = torch.cat([bins[..., :1], bin_centers], dim=-1)
        bins = bin_lower + (bin_upper - bin_lower) * jitter
    else:
        bins = bins.expand(num_rays, num_samples + 1)

    s_near = spacing_fn(spacing, ray_bundle.nears)
    s_far = spacing_fn(spacing, ray_bundle.fars)

    samples = ray_bundle.get_ray_samples(
        bin_starts=bins[..., :-1],  # placeholders, replaced below
        bin_ends=bins[..., 1:],
        spacing_starts=bins[..., :-1],
        spacing_ends=bins[..., 1:],
        spacing=spacing,
        s_near=s_near,
        s_far=s_far,
    )
    euclidean_bins = samples.spacing_to_euclidean(bins)
    return samples.replace(
        starts=euclidean_bins[..., :-1], ends=euclidean_bins[..., 1:]
    )


def pdf_samples(
    ray_bundle: RayBundle,
    ray_samples: RaySamples,
    weights: torch.Tensor,
    num_samples: int,
    jitter: Optional[torch.Tensor] = None,
    include_original: bool = True,
    histogram_padding: float = 0.01,
    eps: float = 1e-5,
) -> RaySamples:
    """Importance-resample bins from a weight histogram (inverse CDF).

    The JAX version reads the CDF and bins at the bracketing indices with
    masked reductions over an [N, Q, K] comparison tensor, which XLA
    fuses; eager PyTorch would materialise it (~1.1 G elements per chunk
    at render width), so this is the searchsorted + gather it stands for:
    ``below = max(i - 1, 0)``, ``above = min(i, K - 1)`` with
    ``i = searchsorted(cdf, u, side="right")``.

    Args:
        weights: [N, S] histogram weights over ``ray_samples``'s bins.
        jitter: optional uniform draws, [N, 1] or [N, num_samples + 1];
            None places u at bin midpoints (eval).
    Returns:
        RaySamples with ``num_samples`` bins (+S if include_original).
    """
    num_bins = num_samples + 1
    weights = weights + histogram_padding

    weights_sum = torch.sum(weights, dim=-1, keepdim=True)
    padding = torch.relu(eps - weights_sum)
    weights = weights + padding / weights.shape[-1]
    weights_sum = weights_sum + padding

    pdf = weights / weights_sum
    cdf = torch.clamp(torch.cumsum(pdf, dim=-1), max=1.0)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)  # [N, K]

    u = torch.linspace(
        0.0, 1.0 - 1.0 / num_bins, num_bins, device=weights.device
    )[None, :]
    if jitter is not None:
        u = u + jitter / num_bins
    else:
        u = u + 1.0 / (2 * num_bins)
    u = u.expand(cdf.shape[0], num_bins).contiguous()

    existing_bins = torch.cat(
        [ray_samples.spacing_starts, ray_samples.spacing_ends[..., -1:]], dim=-1
    )  # [N, K]

    k = cdf.shape[-1]
    inds = searchsorted(cdf, u, side="right").long()
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=k - 1)
    cdf_g0 = torch.gather(cdf, -1, below)
    bins_g0 = torch.gather(existing_bins, -1, below)
    cdf_g1 = torch.gather(cdf, -1, above)
    bins_g1 = torch.gather(existing_bins, -1, above)

    t = torch.clamp(torch.nan_to_num((u - cdf_g0) / (cdf_g1 - cdf_g0)), 0.0, 1.0)
    bins = bins_g0 + t * (bins_g1 - bins_g0)

    if include_original:
        bins, _ = torch.sort(torch.cat([existing_bins, bins], dim=-1), dim=-1)

    bins = bins.detach()

    new_samples = ray_bundle.get_ray_samples(
        bin_starts=bins[..., :-1],  # placeholders, replaced below
        bin_ends=bins[..., 1:],
        spacing_starts=bins[..., :-1],
        spacing_ends=bins[..., 1:],
        spacing=ray_samples.spacing,
        s_near=ray_samples.s_near,
        s_far=ray_samples.s_far,
    )
    euclidean_bins = new_samples.spacing_to_euclidean(bins)
    return new_samples.replace(
        starts=euclidean_bins[..., :-1], ends=euclidean_bins[..., 1:]
    )


def proposal_sample(
    ray_bundle: RayBundle,
    density_fns: Sequence[Callable[[RaySamples], torch.Tensor]],
    num_proposal_samples_per_ray: Tuple[int, ...],
    num_nerf_samples_per_ray: int,
    initial_spacing: str = "piecewise",
    anneal: float = 1.0,
    jitters: Optional[Sequence[Optional[torch.Tensor]]] = None,
    train_proposal_networks: bool = True,
) -> Tuple[RaySamples, List[torch.Tensor], List[RaySamples]]:
    """Hierarchical proposal-network sampling: level 0 from the spaced
    sampler, later levels PDF-resampled from annealed weights; each
    proposal level evaluates its density field.

    Args:
        density_fns: one callable per proposal level, RaySamples -> [N, S].
        anneal: exponent applied to weights before PDF resampling.
        jitters: optional per-level uniform draws (see spaced_samples and
            pdf_samples); None for every level is the eval branch.
        train_proposal_networks: a host bool; when False the proposal
            fields run with grad disabled, so no graph is recorded and no
            backward runs through them (the JAX package's static flag,
            which compiles that backward away).
    Returns:
        (final RaySamples, weights_list, ray_samples_list) over the
        proposal levels.
    """
    n = len(density_fns)
    jitters = list(jitters) if jitters is not None else [None] * (n + 1)
    weights_list: List[torch.Tensor] = []
    ray_samples_list: List[RaySamples] = []

    weights = None
    ray_samples: Optional[RaySamples] = None
    for i_level in range(n + 1):
        is_prop = i_level < n
        num_samples = (
            num_proposal_samples_per_ray[i_level] if is_prop else num_nerf_samples_per_ray
        )
        if i_level == 0:
            ray_samples = spaced_samples(
                ray_bundle, num_samples, spacing=initial_spacing,
                jitter=jitters[0],
            )
        else:
            assert weights is not None and ray_samples is not None
            ray_samples = pdf_samples(
                ray_bundle,
                ray_samples,
                torch.pow(weights, anneal),
                num_samples,
                jitter=jitters[i_level],
                include_original=False,
            )
        if is_prop:
            with torch.set_grad_enabled(torch.is_grad_enabled()
                                        and train_proposal_networks):
                density = density_fns[i_level](ray_samples)
            weights = ray_samples.get_weights(density)
            weights_list.append(weights)
            ray_samples_list.append(ray_samples)

    assert ray_samples is not None
    return ray_samples, weights_list, ray_samples_list
