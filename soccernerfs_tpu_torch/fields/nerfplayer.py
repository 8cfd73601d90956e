"""The full NeRFPlayer field, a static / deforming / new decomposition
(counterpart of soccernerfs_tpu/fields/nerfplayer.py):

  a deformation MLP (3 -> 128 x 3 -> 3) offsets each point;
  the stationary grid (static, zline) is read at the point and at the
    deformed point, each encoding followed by a (features, t) MLP;
  the newness grid (temporal) gives the new content's features;
  the decomposition grid (temporal) -> MLP -> softmax gives the three
    components' probabilities (stationary, deforming, new);
  the probability-mixed features -> decode MLP -> (density, geo), and
    the geo features (with SH directions unless view-independent) -> the
    colour MLP.

Sample positions and times carry no gradient in the registered methods
(``detached_inputs``), so the raw points' encodes detach them; with the
camera optimizer on, the Trainer turns the flag off and they carry the
pose gradient.  The deformed points always carry one: the stationary grid's gradient with
respect to them (``_GatherSum``'s weight gradient) reaches the
deformation MLP.  A deformed point may leave the unit cube; the stationary
grid then hashes negative lattice coordinates and ones beyond the
resolution, as the JAX package does (``ops/hash_grid.py``).  The two
stationary encodes are separate calls, each with its own table gradient,
which autograd sums, as the JAX function's transpose does.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from soccernerfs_tpu_torch.core.math import (
    components_from_spherical_harmonics,
    trunc_exp,
)
from soccernerfs_tpu_torch.fields.nerfacto import _normalize
from soccernerfs_tpu_torch.ops.hash_grid import (
    HashGridConfig,
    hash_grid_encode,
    init_hash_grid,
    temporal_tv_loss,
)
from soccernerfs_tpu_torch.ops.mlp import init_mlp, mlp_apply

# the reference fixes the stationary grid's per-level scale
STATIC_PER_LEVEL_SCALE = 1.4472692012786865


@dataclass(frozen=True)
class NerfplayerFieldConfig:
    """Field names and defaults are the JAX package's."""

    num_layers: int = 3
    hidden_dim: int = 64
    geo_feat_dim: int = 15
    temporal_dim: int = 64
    num_levels: int = 16
    features_per_level: int = 2
    base_resolution: int = 16
    log2_hashmap_size: int = 19
    num_layers_color: int = 4
    hidden_dim_color: int = 64
    disable_viewing_dependent: bool = False
    disable_scene_contraction: bool = False
    num_images: int = 0
    sh_degree: int = 4
    desired_resolution: int = 1024
    detached_inputs: bool = True

    @property
    def feature_dim(self) -> int:
        return self.num_levels * self.features_per_level

    @property
    def static_grid(self) -> HashGridConfig:
        return HashGridConfig(
            num_levels=self.num_levels,
            level_dim=self.features_per_level,
            base_resolution=self.base_resolution,
            per_level_scale=STATIC_PER_LEVEL_SCALE,
            log2_hashmap_size=self.log2_hashmap_size,
            hash_scheme="zline",
        )

    @property
    def temporal_grid(self) -> HashGridConfig:
        return HashGridConfig(
            temporal_dim=self.temporal_dim,
            num_levels=self.num_levels,
            level_dim=self.features_per_level,
            base_resolution=self.base_resolution,
            desired_resolution=self.desired_resolution,
            log2_hashmap_size=self.log2_hashmap_size,
        )


def field_mlp_dims(cfg: NerfplayerFieldConfig) -> dict:
    """{name: (in, hidden, hidden layers, out)} of the field's MLPs."""
    f = cfg.feature_dim
    in_dim_color = cfg.geo_feat_dim
    if not cfg.disable_viewing_dependent:
        in_dim_color += cfg.sh_degree**2
    return {
        "deformation_field": (3, 128, 3, 3),
        "stationary_field_mlp": (f + 1, 64, 1, f),
        "decomposition_mlp": (f, 64, 1, 3),
        "mlp_base_decode": (f, cfg.hidden_dim, cfg.num_layers - 1,
                            1 + cfg.geo_feat_dim),
        "mlp_head": (in_dim_color, cfg.hidden_dim_color,
                     cfg.num_layers_color - 1, 3),
    }


def field_grids(cfg: NerfplayerFieldConfig) -> dict:
    """{name: grid config} of the field's hash grids."""
    return {"stationary_field": cfg.static_grid,
            "newness_field": cfg.temporal_grid,
            "decomposition_field": cfg.temporal_grid}


def init_nerfplayer_field(cfg: NerfplayerFieldConfig,
                          generator: Optional[torch.Generator] = None,
                          device=None) -> dict:
    params = {name: init_hash_grid(grid, generator, device)
              for name, grid in field_grids(cfg).items()}
    for name, dims in field_mlp_dims(cfg).items():
        params[name] = init_mlp(*dims, generator=generator, device=device)
    return params


def nerfplayer_density(
    cfg: NerfplayerFieldConfig, params: dict, aabb: torch.Tensor,
    positions: torch.Tensor, times: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Density [M], geo features [M, geo_feat_dim] and the components'
    probabilities [M, 3] (stationary, deforming, new) at world positions
    [M, 3] and times [M]."""
    pts = _normalize(cfg, positions, aabb)
    t = times[:, None]
    deformed = pts + mlp_apply(params["deformation_field"], pts,
                               activation="relu")
    # the raw points' encodes detach them with ``detached_inputs``; the
    # deformed points' never does (its gradient trains the deformation MLP)
    ig = not cfg.detached_inputs
    v_stat = hash_grid_encode(cfg.static_grid, params["stationary_field"], pts,
                              input_grads=ig)
    v_deform = hash_grid_encode(cfg.static_grid, params["stationary_field"],
                                deformed)
    v_stat = mlp_apply(params["stationary_field_mlp"],
                       torch.cat([v_stat, t], -1), activation="relu")
    v_deform = mlp_apply(params["stationary_field_mlp"],
                         torch.cat([v_deform, t], -1), activation="relu")
    v_new = hash_grid_encode(cfg.temporal_grid, params["newness_field"], pts,
                             times, input_grads=ig)
    v_decomp = hash_grid_encode(cfg.temporal_grid, params["decomposition_field"],
                                pts, times, input_grads=ig)
    probs = torch.softmax(mlp_apply(params["decomposition_mlp"], v_decomp,
                                    activation="relu"), dim=-1)
    v = (probs[:, 0:1] * v_stat + probs[:, 1:2] * v_deform
         + probs[:, 2:3] * v_new)
    h = mlp_apply(params["mlp_base_decode"], v, activation="relu")
    return trunc_exp(h[..., 0]), h[..., 1:], probs


def nerfplayer_rgb(cfg: NerfplayerFieldConfig, params: dict, geo: torch.Tensor,
                   directions: torch.Tensor) -> torch.Tensor:
    """Colour [M, 3] from the geo features, after SH-encoded directions
    unless view-independent."""
    h = geo
    if not cfg.disable_viewing_dependent:
        h = torch.cat([components_from_spherical_harmonics(cfg.sh_degree,
                                                           directions), geo], -1)
    return mlp_apply(params["mlp_head"], h, activation="relu",
                     output_activation="sigmoid")


def nerfplayer_temporal_tv(cfg: NerfplayerFieldConfig, params: dict,
                           rows) -> torch.Tensor:
    """The temporal TV of the newness grid at ``rows[0]`` plus the
    decomposition grid's at ``rows[1]`` (``index_list`` rows, the JAX
    package's two key-split draws)."""
    return (temporal_tv_loss(cfg.temporal_grid, params["newness_field"], rows[0])
            + temporal_tv_loss(cfg.temporal_grid, params["decomposition_field"],
                               rows[1]))
