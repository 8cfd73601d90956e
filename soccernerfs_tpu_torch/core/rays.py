"""Ray containers (counterpart of soccernerfs_tpu/core/rays.py).

Plain dataclasses with a ``replace``: a bundle is a flat batch of N rays,
samples are [N, S], and per-ray scalars carry no trailing singleton dim.
RaySamples records the spacing-warp name plus the warped near/far per ray
instead of a closure, as the JAX version does.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch

# Spacing warps: (euclidean -> s-space, s-space -> euclidean)
_SPACING_FNS = {
    "uniform": (lambda x: x, lambda x: x),
    "lindisp": (lambda x: 1.0 / x, lambda x: 1.0 / x),
    "sqrt": (torch.sqrt, lambda x: x**2),
    "log": (torch.log, torch.exp),
    "piecewise": (
        lambda x: torch.where(x < 1, x / 2.0, 1.0 - 1.0 / (2.0 * x)),
        lambda x: torch.where(x < 0.5, 2.0 * x, 1.0 / (2.0 - 2.0 * x)),
    ),
}


def spacing_fn(name: str, x: torch.Tensor) -> torch.Tensor:
    """Euclidean distance -> warped s-space."""
    return _SPACING_FNS[name][0](x)


def spacing_fn_inv(name: str, x: torch.Tensor) -> torch.Tensor:
    """Warped s-space -> euclidean distance."""
    return _SPACING_FNS[name][1](x)


class _Replace:
    def replace(self, **changes):
        return dataclasses.replace(self, **changes)


@dataclass
class Frustums(_Replace):
    """Conical frustum segments along rays."""

    origins: torch.Tensor  # [..., 3]
    directions: torch.Tensor  # [..., 3]
    starts: torch.Tensor  # [...]
    ends: torch.Tensor  # [...]
    pixel_area: torch.Tensor  # [...]

    def get_positions(self) -> torch.Tensor:
        mids = (self.starts + self.ends) / 2.0
        return self.origins + self.directions * mids[..., None]


@dataclass
class RayBundle(_Replace):
    """A flat batch of rays; optional per-ray scalars are [N]."""

    origins: torch.Tensor  # [N, 3]
    directions: torch.Tensor  # [N, 3] unit vectors
    pixel_area: torch.Tensor  # [N]
    camera_indices: Optional[torch.Tensor] = None  # [N] int32
    nears: Optional[torch.Tensor] = None  # [N]
    fars: Optional[torch.Tensor] = None  # [N]
    times: Optional[torch.Tensor] = None  # [N] in [0, 1]
    directions_norm: Optional[torch.Tensor] = None  # [N]

    @property
    def num_rays(self) -> int:
        return self.origins.shape[0]

    def get_ray_samples(
        self,
        bin_starts: torch.Tensor,
        bin_ends: torch.Tensor,
        spacing_starts: torch.Tensor,
        spacing_ends: torch.Tensor,
        spacing: str,
        s_near: torch.Tensor,
        s_far: torch.Tensor,
    ) -> "RaySamples":
        """Project bin edges along rays into RaySamples."""
        return RaySamples(
            origins=self.origins,
            directions=self.directions,
            pixel_area=self.pixel_area,
            starts=bin_starts,
            ends=bin_ends,
            spacing_starts=spacing_starts,
            spacing_ends=spacing_ends,
            s_near=s_near,
            s_far=s_far,
            spacing=spacing,
            camera_indices=self.camera_indices,
            times=self.times,
        )


@dataclass
class RaySamples(_Replace):
    """[N, S] samples along N rays."""

    origins: torch.Tensor  # [N, 3]
    directions: torch.Tensor  # [N, 3]
    pixel_area: torch.Tensor  # [N]
    starts: torch.Tensor  # [N, S] euclidean bin starts
    ends: torch.Tensor  # [N, S] euclidean bin ends
    spacing_starts: torch.Tensor  # [N, S] s-space bin starts
    spacing_ends: torch.Tensor  # [N, S] s-space bin ends
    s_near: torch.Tensor  # [N]
    s_far: torch.Tensor  # [N]
    spacing: str = "uniform"
    camera_indices: Optional[torch.Tensor] = None  # [N] int32
    times: Optional[torch.Tensor] = None  # [N]

    @property
    def deltas(self) -> torch.Tensor:
        return self.ends - self.starts

    @property
    def frustums(self) -> Frustums:
        return Frustums(
            origins=self.origins[..., None, :],
            directions=self.directions[..., None, :],
            starts=self.starts,
            ends=self.ends,
            pixel_area=self.pixel_area[..., None],
        )

    def midpoints(self) -> torch.Tensor:
        return (self.starts + self.ends) / 2.0

    def get_positions(self) -> torch.Tensor:
        """[N, S, 3] world positions at bin midpoints."""
        return (
            self.origins[..., None, :]
            + self.directions[..., None, :] * self.midpoints()[..., None]
        )

    def spacing_to_euclidean(self, x: torch.Tensor) -> torch.Tensor:
        """s-space bin coordinates in [0, 1] -> euclidean distances."""
        s_near = self.s_near[..., None]
        s_far = self.s_far[..., None]
        return spacing_fn_inv(self.spacing, x * s_far + (1.0 - x) * s_near)

    def get_weights(self, densities: torch.Tensor) -> torch.Tensor:
        """Volume-rendering weights w_i = (1 - exp(-sigma_i delta_i)) *
        exp(-sum_{j<i} sigma_j delta_j), NaN-scrubbed.  [N, S] -> [N, S]."""
        # an overflowed (inf) density counts as the largest float, so that
        # the deltas' gradient (the camera optimizer's) takes 0 * max, not
        # 0 * inf; every finite density passes unchanged
        densities = torch.clamp(densities, max=torch.finfo(densities.dtype).max)
        delta_density = self.deltas * densities
        alphas = 1.0 - torch.exp(-delta_density)
        shifted = torch.cat(
            [torch.zeros_like(delta_density[..., :1]), delta_density[..., :-1]],
            dim=-1,
        )
        transmittance = torch.exp(-torch.cumsum(shifted, dim=-1))
        return torch.nan_to_num(alphas * transmittance)


def get_weights_and_transmittance_from_alphas(alphas: torch.Tensor,
                                              weights_only: bool = False):
    """Weights from per-sample alphas [N, S]: w_i = alpha_i * T_i with
    T = cumprod([1, 1 - alpha + 1e-7]) (the 1e-7 inside the product, as
    the JAX version has it).  Returns weights [N, S], or (weights,
    transmittance [N, S + 1])."""
    transmittance = torch.cumprod(
        torch.cat([torch.ones_like(alphas[..., :1]), 1.0 - alphas + 1e-7],
                  dim=-1), dim=-1)
    weights = alphas * transmittance[..., :-1]
    if weights_only:
        return weights
    return weights, transmittance
