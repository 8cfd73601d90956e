"""Occupancy grid and fixed-shape volumetric sampling (counterpart of
soccernerfs_tpu/ops/occupancy.py), the sampler of the occupancy-grid
methods.

Sampling has static shapes, as the JAX package's: T equally spaced probes
per ray are tested against the binarized grid, and the first S occupied
ones (a prefix count, then ``searchsorted``) become the samples, padded and
masked when a ray has fewer.  The grid is an EMA of density: every update
probes jittered cell positions and keeps ``max(occ * decay, density *
step_size)``; before ``warmup_steps`` every cell is probed, after it
``n_cells // 4`` cells (half uniform, half drawn with replacement from the
binarized grid's CDF), duplicates resolved by a per-cell max.

Randomness is explicit: the stratified jitter and the update's draws (cell
jitter, uniform cells, occupied-cell uniforms) are arguments, or come from
a ``torch.Generator``, so tests can hand the port the JAX package's draws.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch

from soccernerfs_tpu_torch.core.rays import RayBundle, RaySamples
from soccernerfs_tpu_torch.ops.searching import searchsorted

# cells per density call of an update: the probe is per point, so chunks
# give the same values and bound the encoders' temporaries
PROBE_CHUNK = 1 << 19


@dataclass(frozen=True)
class OccupancyGridConfig:
    """Field names and defaults are the JAX package's."""

    resolution: int = 128
    ema_decay: float = 0.95
    occ_threshold: float = 0.01
    update_every: int = 16
    warmup_steps: int = 256

    @property
    def n_cells(self) -> int:
        return self.resolution**3


def init_occupancy_grid(cfg: OccupancyGridConfig, device=None) -> torch.Tensor:
    """Dense [R^3] running density estimate, zeros."""
    return torch.zeros((cfg.n_cells,), dtype=torch.float32, device=device)


def occupancy_binary(cfg: OccupancyGridConfig, occs: torch.Tensor) -> torch.Tensor:
    """nerfacc's binarization: occ > min(mean(occ), threshold).

    The mean is summed in f64 and rounded to f32, so that the card and the
    CPU threshold alike: the f32 means of their reductions differ in the
    last bits, and a fog's cells crowd around the mean.  The JAX package
    takes an f32 mean; cells within its rounding of the threshold may fall
    the other way."""
    mean = occs.double().mean().float()
    return occs > torch.clamp(mean, max=cfg.occ_threshold)


def probes_all_cells(cfg: OccupancyGridConfig, step: Optional[int]) -> bool:
    """Whether the update at ``step`` probes every cell (warmup, or no
    step) rather than ``n_cells // 4`` sampled ones."""
    return step is None or step < cfg.warmup_steps


def update_draws(cfg: OccupancyGridConfig, step: Optional[int],
                 generator: Optional[torch.Generator], device
                 ) -> Dict[str, torch.Tensor]:
    """The draws of one update at ``step`` (None: the all-cells update):
    "jitter" [cells, 3] uniform per probed cell; after warmup also
    "cells" [m // 2] int64 uniform cells and "occupied" [m - m // 2]
    uniforms of the CDF draw, m = n_cells // 4."""
    n = cfg.n_cells
    if probes_all_cells(cfg, step):
        return {"jitter": torch.rand((n, 3), generator=generator, device=device)}
    m = max(n // 4, 1)
    return {
        "jitter": torch.rand((m, 3), generator=generator, device=device),
        "cells": torch.randint(0, n, (m // 2,), generator=generator,
                               device=device),
        "occupied": torch.rand((m - m // 2,), generator=generator,
                               device=device),
    }


def update_occupancy_grid(
    cfg: OccupancyGridConfig,
    occs: torch.Tensor,
    aabb: torch.Tensor,
    density_fn: Callable[[torch.Tensor], torch.Tensor],
    render_step_size: float,
    step: Optional[int] = None,
    draws: Optional[Dict[str, torch.Tensor]] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """One EMA update from jittered cell-position density queries.

    Args:
        occs: [R^3] running estimate.
        density_fn: world positions [M, 3] -> density [M].
        step: the train step; before ``warmup_steps`` (or None) every cell
            is probed, after it ``n_cells // 4`` (see the module's text).
        draws: ``update_draws``' layout; drawn from ``generator`` when
            None.
    Returns:
        The new [R^3] estimate (a new tensor).  The probe runs without
        autograd, ``PROBE_CHUNK`` cells per density call.
    """
    r = cfg.resolution
    n = cfg.n_cells
    if draws is None:
        draws = update_draws(cfg, step, generator, occs.device)
    full = probes_all_cells(cfg, step)
    if full:
        cells = torch.arange(n, device=occs.device)
    else:
        # the occupied-cell draw: uniform over the binarized grid through
        # its CDF (an all-empty grid degrades to uniform via the epsilon)
        w = occupancy_binary(cfg, occs).float() + 1e-12
        cdf = torch.cumsum(w, 0)
        picks = torch.searchsorted(cdf, draws["occupied"] * cdf[-1])
        cells = torch.cat([draws["cells"].long(), picks.clamp(0, n - 1)])
    jitter = draws["jitter"]
    if jitter.shape != (cells.shape[0], 3):
        raise ValueError(f"jitter must be [{cells.shape[0]}, 3], got "
                         f"{list(jitter.shape)}")
    density = torch.empty((cells.shape[0],), dtype=torch.float32,
                          device=occs.device)
    with torch.no_grad():
        for i in range(0, cells.shape[0], PROBE_CHUNK):
            c = cells[i:i + PROBE_CHUNK]
            ijk = torch.stack([c // (r * r), (c // r) % r, c % r], dim=-1)
            pos01 = (ijk.float() + jitter[i:i + PROBE_CHUNK]) / r
            positions = aabb[0] + pos01 * (aabb[1] - aabb[0])
            density[i:i + PROBE_CHUNK] = density_fn(positions) * render_step_size
    if full:
        return torch.maximum(occs * cfg.ema_decay, density)
    # duplicate-safe: a probed mask and a per-cell max of the new values
    # (onto zeros, as the JAX package's), then one select
    probed = torch.zeros((n,), dtype=torch.bool, device=occs.device)
    probed[cells] = True
    dmax = torch.zeros_like(occs).scatter_reduce_(0, cells, density, "amax")
    return torch.where(probed, torch.maximum(occs * cfg.ema_decay, dmax), occs)


def occupancy_lookup(
    cfg: OccupancyGridConfig,
    binary: torch.Tensor,
    aabb: torch.Tensor,
    positions: torch.Tensor,
) -> torch.Tensor:
    """Boolean occupancy at world positions [..., 3]: false outside the
    box."""
    r = cfg.resolution
    pos01 = (positions - aabb[0]) / (aabb[1] - aabb[0])
    inside = torch.all((pos01 >= 0.0) & (pos01 < 1.0), dim=-1)
    # truncation toward zero, as the JAX package's int32 cast
    ijk = torch.clamp((pos01 * r).to(torch.int32), 0, r - 1).long()
    idx = (ijk[..., 0] * r + ijk[..., 1]) * r + ijk[..., 2]
    return binary[idx] & inside


def volumetric_sample(
    cfg: OccupancyGridConfig,
    binary: torch.Tensor,
    ray_bundle: RayBundle,
    aabb: torch.Tensor,
    num_probes: int,
    max_samples_per_ray: int,
    jitter: Optional[torch.Tensor] = None,
) -> Tuple[RaySamples, torch.Tensor]:
    """Occupancy-guided sampling with static shapes.

    Args:
        binary: [R^3] bool grid.
        ray_bundle: rays with nears and fars.
        num_probes: T probes per ray (sets the effective step size).
        max_samples_per_ray: S kept samples per ray.
        jitter: [N, 1] uniforms in [0, 1): a stratified shift of the probe
            edges by ``jitter / T`` (training); None for none.
    Returns:
        (RaySamples [N, S] with "uniform" spacing over [near, far], valid
        mask [N, S]).  An invalid sample sits on the last probe.
    """
    if ray_bundle.nears is None or ray_bundle.fars is None:
        raise ValueError("volumetric_sample needs the rays' nears and fars")
    n = ray_bundle.num_rays
    dev = ray_bundle.origins.device
    T, S = num_probes, max_samples_per_ray

    # i / T in f32, as jnp.linspace computes it (torch.linspace may differ
    # by an ulp)
    edges = (torch.arange(T + 1, dtype=torch.float32, device=dev) / T)[None, :]
    if jitter is not None:
        edges = edges + jitter / T                                 # [N, T+1]
    nears = ray_bundle.nears[:, None]
    fars = ray_bundle.fars[:, None]
    t_edges = nears + edges * (fars - nears)
    t_mid = (t_edges[:, :-1] + t_edges[:, 1:]) / 2.0               # [N, T]
    probe_pos = (ray_bundle.origins[:, None, :]
                 + ray_bundle.directions[:, None, :] * t_mid[..., None])
    occupied = occupancy_lookup(cfg, binary, aabb, probe_pos)      # [N, T]

    # the s-th occupied probe is the first whose 1-based prefix count is s
    rank = torch.cumsum(occupied.to(torch.int32), dim=-1, dtype=torch.int32)
    targets = torch.arange(1, S + 1, dtype=torch.int32, device=dev)[None, :]
    sel = searchsorted(rank, targets.expand(n, S), side="left")
    sel = torch.clamp(sel, 0, T - 1).long()                        # [N, S]
    valid = targets <= rank[:, -1:]

    edges = edges.expand(n, T + 1)
    samples = RaySamples(
        origins=ray_bundle.origins,
        directions=ray_bundle.directions,
        pixel_area=ray_bundle.pixel_area,
        starts=torch.gather(t_edges[:, :-1], 1, sel),
        ends=torch.gather(t_edges[:, 1:], 1, sel),
        spacing_starts=torch.gather(edges[:, :-1], 1, sel),
        spacing_ends=torch.gather(edges[:, 1:], 1, sel),
        s_near=ray_bundle.nears,
        s_far=ray_bundle.fars,
        spacing="uniform",
        camera_indices=ray_bundle.camera_indices,
        times=ray_bundle.times,
    )
    return samples, valid
