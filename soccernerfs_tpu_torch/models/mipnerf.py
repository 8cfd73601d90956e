"""mip-NeRF model (counterpart of soccernerfs_tpu/models/mipnerf.py).

One field, shared by both passes, queried with the integrated positional
encoding (16 frequencies to 2^16) of each sample's conical frustum as a
Gaussian (``ops/encodings.conical_frustum_to_gaussian``), the cone's
radius sqrt(pixel_area) / sqrt(pi); coarse uniform samples, then PDF
samples merged with the coarse bins, as vanilla NeRF's
(``models/vanilla_nerf.py``, whose draws and schedules it shares); the MSE
of both renders.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from soccernerfs_tpu_torch.core.rays import RayBundle, RaySamples
from soccernerfs_tpu_torch.fields.vanilla_nerf import (
    NeRFFieldConfig,
    init_nerf_field,
    nerf_field_forward,
)
from soccernerfs_tpu_torch.models.vanilla_nerf import (  # noqa: F401  (protocol)
    coarse_and_fine,
    get_loss_dict,
    get_metrics_dict,
    host_static_kwargs,
    proposal_anneal,
    sample_counts,
    train_draws,
)
from soccernerfs_tpu_torch.ops.encodings import conical_frustum_to_gaussian
from soccernerfs_tpu_torch.ops.rendering import (
    render_accumulation,
    render_depth,
    render_rgb,
)

# the JAX version's f32 divisor, sqrt(pi)
SQRT_PI = 1.7724538509055159


@dataclass(frozen=True)
class Config:
    """mip-NeRF model config; field names and defaults are the JAX
    package's (its ``models/mipnerf.Config``)."""

    num_coarse_samples: int = 128
    num_importance_samples: int = 128
    near_plane: float = 2.0
    far_plane: float = 6.0
    background_color: str = "white"
    eval_num_rays_per_chunk: int = 1024

    def field_config(self) -> NeRFFieldConfig:
        return NeRFFieldConfig(position_encoding_num_frequencies=16,
                               position_encoding_max=16.0,
                               use_integrated_encoding=True)


def init(cfg: Config, num_train_data: int = 0,
         generator: Optional[torch.Generator] = None, device=None) -> dict:
    """Param dict {"fields": the one field} in the JAX package's layout."""
    return {"fields": init_nerf_field(cfg.field_config(), generator, device)}


def get_outputs(
    cfg: Config,
    params: dict,
    aabb: torch.Tensor,
    ray_bundle: RayBundle,
    train: bool = False,
    anneal: float = 1.0,
    train_proposal_networks: bool = True,
    jitters: Optional[Sequence[torch.Tensor]] = None,
    background: Optional[torch.Tensor] = None,
) -> dict:
    """Forward: rgb_coarse / rgb_fine [N, 3] (rgb is the fine one), the
    fine pass's accumulation and depth.  ``aabb``, ``anneal``,
    ``train_proposal_networks`` and ``background`` are not read."""
    del aabb, anneal, train_proposal_networks, background
    fcfg = cfg.field_config()

    def field_fn(samples: RaySamples, level: str):
        n, s = samples.starts.shape
        origins = samples.origins[:, None, :].expand(n, s, 3)
        dirs = samples.directions[:, None, :].expand(n, s, 3)
        radius = (torch.sqrt(samples.pixel_area)[:, None, None]
                  / SQRT_PI).expand(n, s, 1)
        means, covs = conical_frustum_to_gaussian(
            origins, dirs, samples.starts[..., None], samples.ends[..., None],
            radius)
        density, rgb = nerf_field_forward(
            fcfg, params["fields"], means.reshape(-1, 3), dirs.reshape(-1, 3),
            covs=covs.reshape(-1, 3, 3))
        return density.reshape(n, s), rgb.reshape(n, s, 3)

    (_coarse, weights_c, rgb_c), (fine, weights_f, rgb_f) = coarse_and_fine(
        cfg, ray_bundle, field_fn, train, jitters)
    bg = cfg.background_color
    outputs = {
        "rgb_coarse": render_rgb(rgb_c, weights_c, bg, train),
        "rgb_fine": render_rgb(rgb_f, weights_f, bg, train),
        "accumulation": render_accumulation(weights_f),
        "depth": render_depth(weights_f, fine),
    }
    outputs["rgb"] = outputs["rgb_fine"]
    return outputs
