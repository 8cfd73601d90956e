"""NeRFPlayer-nerfacto field and its temporal proposal density field
(counterpart of soccernerfs_tpu/fields/nerfplayer_nerfacto.py): a temporal
hash grid, a decode MLP, and nerfacto's SH direction and appearance colour
head; the proposal fields are a temporal hash grid behind a density MLP.

Sample positions and times carry no gradient in the registered method
(``detached_inputs``: PDF bins detached, camera optimizer off); the
temporal encoder has no position or time backward, so a config that asks
for one raises.
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
)
from soccernerfs_tpu_torch.ops.mlp import init_mlp, mlp_apply


def _detached(cfg) -> None:
    if not cfg.detached_inputs:
        raise NotImplementedError(
            "position and time gradients of the temporal grids are not "
            "ported (detached_inputs=False)")


@dataclass(frozen=True)
class NerfplayerNerfactoFieldConfig:
    """Field names and defaults are the JAX package's."""

    num_layers: int = 2
    hidden_dim: int = 64
    geo_feat_dim: int = 15
    temporal_dim: int = 64
    num_levels: int = 16
    features_per_level: int = 2
    log2_hashmap_size: int = 19
    num_layers_color: int = 3
    hidden_dim_color: int = 64
    appearance_embedding_dim: int = 32
    use_appearance_embedding: bool = True
    use_average_appearance_embedding: bool = False
    disable_viewing_dependent: bool = False
    disable_scene_contraction: bool = False
    num_images: int = 0
    sh_degree: int = 4
    desired_resolution: int = 1024
    detached_inputs: bool = True

    def __post_init__(self):
        _detached(self)

    @property
    def grid(self) -> HashGridConfig:
        return HashGridConfig(
            temporal_dim=self.temporal_dim,
            num_levels=self.num_levels,
            level_dim=self.features_per_level,
            log2_hashmap_size=self.log2_hashmap_size,
            desired_resolution=self.desired_resolution,
        )


def field_mlp_dims(cfg: NerfplayerNerfactoFieldConfig) -> dict:
    """{name: (in, hidden, hidden layers, out)} of the field's MLPs."""
    in_dim_color = cfg.geo_feat_dim
    if not cfg.disable_viewing_dependent:
        in_dim_color += cfg.sh_degree**2
    if cfg.use_appearance_embedding:
        in_dim_color += cfg.appearance_embedding_dim
    return {
        "mlp_base_decode": (cfg.num_levels * cfg.features_per_level,
                            cfg.hidden_dim, cfg.num_layers - 1,
                            1 + cfg.geo_feat_dim),
        "mlp_head": (in_dim_color, cfg.hidden_dim_color,
                     cfg.num_layers_color - 1, 3),
    }


def init_nerfplayer_nerfacto_field(cfg: NerfplayerNerfactoFieldConfig,
                                   generator: Optional[torch.Generator] = None,
                                   device=None) -> dict:
    params = {"grid": init_hash_grid(cfg.grid, generator, device)}
    dims = field_mlp_dims(cfg)
    params["mlp_base_decode"] = init_mlp(*dims["mlp_base_decode"],
                                         generator=generator, device=device)
    if cfg.use_appearance_embedding:
        params["appearance_embedding"] = torch.randn(
            (max(cfg.num_images, 1), cfg.appearance_embedding_dim),
            generator=generator).to(device)
    params["mlp_head"] = init_mlp(*dims["mlp_head"], generator=generator,
                                  device=device)
    return params


def nerfplayer_nerfacto_density(
    cfg: NerfplayerNerfactoFieldConfig, params: dict, aabb: torch.Tensor,
    positions: torch.Tensor, times: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Density [M] and geo features [M, geo_feat_dim] at world positions
    [M, 3] and times [M]."""
    pts = _normalize(cfg, positions, aabb)
    feats = hash_grid_encode(cfg.grid, params["grid"], pts, times)
    out = mlp_apply(params["mlp_base_decode"], feats, activation="relu")
    return trunc_exp(out[..., 0]), out[..., 1:]


def nerfplayer_nerfacto_rgb(
    cfg: NerfplayerNerfactoFieldConfig,
    params: dict,
    geo_feats: torch.Tensor,
    directions: torch.Tensor,
    camera_indices: Optional[torch.Tensor],
    train: bool = True,
) -> torch.Tensor:
    """Colour [M, 3] from SH-encoded directions (unless view-independent),
    geo features and the appearance embedding: the camera's row in
    training; outside it the mean row (``use_average_appearance_embedding``)
    or zeros."""
    parts = []
    if not cfg.disable_viewing_dependent:
        parts.append(components_from_spherical_harmonics(cfg.sh_degree,
                                                         directions))
    parts.append(geo_feats)
    if cfg.use_appearance_embedding:
        emb = params["appearance_embedding"]
        m = directions.shape[0]
        if train:
            assert camera_indices is not None
            parts.append(emb[camera_indices.long()])
        elif cfg.use_average_appearance_embedding:
            parts.append(emb.mean(dim=0).expand(m, emb.shape[-1]))
        else:
            parts.append(torch.zeros((m, emb.shape[-1]), device=emb.device))
    h = torch.cat(parts, dim=-1)
    return mlp_apply(params["mlp_head"], h, activation="relu",
                     output_activation="sigmoid")


# ---------------------------------------------------------------------------
# temporal proposal density field
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TemporalHashMLPDensityFieldConfig:
    """Field names and defaults are the JAX package's; its grid hashes with
    zline."""

    temporal_dim: int = 64
    num_layers: int = 2
    hidden_dim: int = 64
    num_levels: int = 8
    max_res: int = 1024
    base_res: int = 16
    log2_hashmap_size: int = 18
    features_per_level: int = 2
    disable_scene_contraction: bool = False
    detached_inputs: bool = True

    def __post_init__(self):
        _detached(self)

    @property
    def grid(self) -> HashGridConfig:
        return HashGridConfig(
            temporal_dim=self.temporal_dim,
            num_levels=self.num_levels,
            level_dim=self.features_per_level,
            base_resolution=self.base_res,
            desired_resolution=self.max_res,
            log2_hashmap_size=self.log2_hashmap_size,
            hash_scheme="zline",
        )


def proposal_mlp_dims(cfg: TemporalHashMLPDensityFieldConfig) -> tuple:
    """(in, hidden, hidden layers, out) of the density MLP."""
    return (cfg.num_levels * cfg.features_per_level, cfg.hidden_dim,
            cfg.num_layers - 1, 1)


def init_temporal_density_field(cfg: TemporalHashMLPDensityFieldConfig,
                                generator: Optional[torch.Generator] = None,
                                device=None) -> dict:
    return {
        "grid": init_hash_grid(cfg.grid, generator, device),
        "mlp": init_mlp(*proposal_mlp_dims(cfg), generator=generator,
                        device=device),
    }


def temporal_density_field_density(
    cfg: TemporalHashMLPDensityFieldConfig, params: dict, aabb: torch.Tensor,
    positions: torch.Tensor, times: torch.Tensor,
) -> torch.Tensor:
    """Density [M] at world positions [M, 3] and times [M]."""
    pts = _normalize(cfg, positions, aabb)
    feats = hash_grid_encode(cfg.grid, params["grid"], pts, times)
    return trunc_exp(mlp_apply(params["mlp"], feats, activation="relu")[..., 0])
