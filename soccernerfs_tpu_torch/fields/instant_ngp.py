"""Instant-NGP field (counterpart of soccernerfs_tpu/fields/instant_ngp.py):
a static hash grid (zline), a base MLP giving density and geo features,
and a colour MLP over SH-encoded directions, geo features and an optional
appearance embedding; positions are normalised by the scene box or
contracted (unbounded sphere or cube).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from soccernerfs_tpu_torch.core.math import (
    components_from_spherical_harmonics,
    scene_contraction,
    trunc_exp,
)
from soccernerfs_tpu_torch.core.scene_box import SceneBox
from soccernerfs_tpu_torch.ops.hash_grid import (
    HashGridConfig,
    hash_grid_encode,
    init_hash_grid,
)
from soccernerfs_tpu_torch.ops.mlp import init_mlp, mlp_apply


@dataclass(frozen=True)
class InstantNGPFieldConfig:
    """Field names and defaults are the JAX package's."""

    num_layers: int = 2
    hidden_dim: int = 64
    geo_feat_dim: int = 15
    num_layers_color: int = 3
    hidden_dim_color: int = 64
    num_levels: int = 16
    features_per_level: int = 2
    base_res: int = 16
    max_res: int = 2048
    log2_hashmap_size: int = 19
    use_appearance_embedding: bool = False
    appearance_embedding_dim: int = 32
    num_images: int = 0
    contraction_type: str = "un_bounded_sphere"  # aabb | un_bounded_sphere | un_bounded_tanh
    sh_degree: int = 4

    @property
    def grid(self) -> HashGridConfig:
        return HashGridConfig(
            num_levels=self.num_levels,
            level_dim=self.features_per_level,
            base_resolution=self.base_res,
            desired_resolution=self.max_res,
            log2_hashmap_size=self.log2_hashmap_size,
            hash_scheme="zline",
        )


def field_mlp_dims(cfg: InstantNGPFieldConfig) -> dict:
    """{name: (in, hidden, hidden layers, out)} of the field's MLPs."""
    in_dim_color = cfg.geo_feat_dim + cfg.sh_degree**2
    if cfg.use_appearance_embedding:
        in_dim_color += cfg.appearance_embedding_dim
    return {
        "mlp_base": (cfg.num_levels * cfg.features_per_level, cfg.hidden_dim,
                     cfg.num_layers - 1, 1 + cfg.geo_feat_dim),
        "mlp_head": (in_dim_color, cfg.hidden_dim_color,
                     cfg.num_layers_color - 1, 3),
    }


def init_instant_ngp_field(cfg: InstantNGPFieldConfig,
                           generator: Optional[torch.Generator] = None,
                           device=None) -> dict:
    dims = field_mlp_dims(cfg)
    params = {"grid": init_hash_grid(cfg.grid, generator, device),
              "mlp_base": init_mlp(*dims["mlp_base"], generator=generator,
                                   device=device)}
    if cfg.use_appearance_embedding:
        params["appearance_embedding"] = torch.randn(
            (max(cfg.num_images, 1), cfg.appearance_embedding_dim),
            generator=generator).to(device)
    params["mlp_head"] = init_mlp(*dims["mlp_head"], generator=generator,
                                  device=device)
    return params


def _normalize(cfg, positions: torch.Tensor, aabb: torch.Tensor) -> torch.Tensor:
    """Positions -> [0, 1]^3: the scene box's normalisation ("aabb"), else
    the contraction onto the radius-2 ball ("un_bounded_sphere") or cube,
    shifted and scaled."""
    if cfg.contraction_type == "aabb":
        return SceneBox.get_normalized_positions(positions, aabb)
    order = None if cfg.contraction_type == "un_bounded_sphere" else math.inf
    return (scene_contraction(positions, order=order) + 2.0) / 4.0


def instant_ngp_density(
    cfg: InstantNGPFieldConfig, params: dict, aabb: torch.Tensor,
    positions: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Density [M] and geo features [M, geo_feat_dim] at world positions
    [M, 3]."""
    pts = _normalize(cfg, positions, aabb)
    feats = hash_grid_encode(cfg.grid, params["grid"], pts)
    out = mlp_apply(params["mlp_base"], feats, activation="relu")
    return trunc_exp(out[..., 0]), out[..., 1:]


def instant_ngp_rgb(
    cfg: InstantNGPFieldConfig,
    params: dict,
    geo: torch.Tensor,
    directions: torch.Tensor,
    camera_indices: Optional[torch.Tensor],
    train: bool = True,
) -> torch.Tensor:
    """Colour [M, 3] from SH-encoded directions, geo features and the
    appearance embedding (the camera's row in training, the mean row
    outside it)."""
    parts = [components_from_spherical_harmonics(cfg.sh_degree, directions), geo]
    if cfg.use_appearance_embedding:
        emb = params["appearance_embedding"]
        if train:
            if camera_indices is None:
                raise ValueError("training needs the rays' camera indices")
            parts.append(emb[camera_indices.long()])
        else:
            parts.append(emb.mean(dim=0).expand(directions.shape[0], emb.shape[-1]))
    h = torch.cat(parts, dim=-1)
    return mlp_apply(params["mlp_head"], h, activation="relu",
                     output_activation="sigmoid")
