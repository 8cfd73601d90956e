"""NeRFPlayer-NGP field (counterpart of
soccernerfs_tpu/fields/nerfplayer_ngp.py): a temporal hash grid (xor), a
base MLP giving density and geo features, and a colour MLP over geo
features, SH-encoded directions unless view-independent (the default),
and an optional appearance embedding; instant-NGP's normalisation.

Sample positions and times carry no gradient in the registered method
(``detached_inputs``; no camera optimizer), so the encode detaches them;
with the flag off it differentiates them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from soccernerfs_tpu_torch.core.math import (
    components_from_spherical_harmonics,
    trunc_exp,
)
from soccernerfs_tpu_torch.fields.instant_ngp import _normalize
from soccernerfs_tpu_torch.ops.hash_grid import (
    HashGridConfig,
    hash_grid_encode,
    init_hash_grid,
)
from soccernerfs_tpu_torch.ops.mlp import init_mlp, mlp_apply


@dataclass(frozen=True)
class NerfplayerNGPFieldConfig:
    """Field names and defaults are the JAX package's."""

    temporal_dim: int = 64
    num_levels: int = 16
    features_per_level: int = 2
    base_resolution: int = 16
    max_res: int = 2048
    log2_hashmap_size: int = 17
    num_layers: int = 2
    hidden_dim: int = 64
    geo_feat_dim: int = 15
    num_layers_color: int = 3
    hidden_dim_color: int = 64
    use_appearance_embedding: bool = False
    appearance_embedding_dim: int = 32
    num_images: int = 0
    disable_viewing_dependent: bool = True
    contraction_type: str = "aabb"
    sh_degree: int = 4
    detached_inputs: bool = True

    @property
    def grid(self) -> HashGridConfig:
        return HashGridConfig(
            temporal_dim=self.temporal_dim,
            num_levels=self.num_levels,
            level_dim=self.features_per_level,
            base_resolution=self.base_resolution,
            desired_resolution=self.max_res,
            log2_hashmap_size=self.log2_hashmap_size,
        )


def field_mlp_dims(cfg: NerfplayerNGPFieldConfig) -> dict:
    """{name: (in, hidden, hidden layers, out)} of the field's MLPs."""
    in_dim_color = cfg.geo_feat_dim
    if not cfg.disable_viewing_dependent:
        in_dim_color += cfg.sh_degree**2
    if cfg.use_appearance_embedding:
        in_dim_color += cfg.appearance_embedding_dim
    return {
        "mlp_base": (cfg.num_levels * cfg.features_per_level, cfg.hidden_dim,
                     cfg.num_layers - 1, 1 + cfg.geo_feat_dim),
        "mlp_head": (in_dim_color, cfg.hidden_dim_color,
                     cfg.num_layers_color - 1, 3),
    }


def init_nerfplayer_ngp_field(cfg: NerfplayerNGPFieldConfig,
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


def nerfplayer_ngp_density(
    cfg: NerfplayerNGPFieldConfig, params: dict, aabb: torch.Tensor,
    positions: torch.Tensor, times: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Density [M] and geo features [M, geo_feat_dim] at world positions
    [M, 3] and times [M]."""
    pts = _normalize(cfg, positions, aabb)
    feats = hash_grid_encode(cfg.grid, params["grid"], pts, times,
                             input_grads=not cfg.detached_inputs)
    out = mlp_apply(params["mlp_base"], feats, activation="relu")
    return trunc_exp(out[..., 0]), out[..., 1:]


def nerfplayer_ngp_rgb(
    cfg: NerfplayerNGPFieldConfig,
    params: dict,
    geo: torch.Tensor,
    directions: torch.Tensor,
    camera_indices: Optional[torch.Tensor],
    train: bool = True,
) -> torch.Tensor:
    """Colour [M, 3] from SH-encoded directions (unless view-independent),
    geo features and the appearance embedding (the camera's row in
    training, the mean row outside it)."""
    parts = []
    if not cfg.disable_viewing_dependent:
        parts.append(components_from_spherical_harmonics(cfg.sh_degree,
                                                         directions))
    parts.append(geo)
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
