"""Nerfacto field and its proposal density field (counterpart of
soccernerfs_tpu/fields/nerfacto.py): a hash grid and bf16-policy MLPs, an
SH direction encoding and per-camera appearance embeddings.

With ``use_pred_normals`` the field also has a predicted-normals head
(``mlp_pred_normals`` over the positions and geo features) and gives
density-gradient normals (``nerfacto_normals``: ``torch.autograd.grad`` of
the re-evaluated density where the JAX package takes ``jax.grad``).
"""
from __future__ import annotations

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
class NerfactoFieldConfig:
    """Field names and defaults are the JAX package's."""

    num_layers: int = 2
    hidden_dim: int = 64
    geo_feat_dim: int = 15
    num_levels: int = 16
    base_res: int = 16
    max_res: int = 2048
    log2_hashmap_size: int = 19
    features_per_level: int = 2
    num_layers_color: int = 3
    hidden_dim_color: int = 64
    appearance_embedding_dim: int = 32
    use_appearance_embedding: bool = True
    use_average_appearance_embedding: bool = False
    use_pred_normals: bool = False
    disable_scene_contraction: bool = False
    num_images: int = 0
    sh_degree: int = 4

    @property
    def grid(self) -> HashGridConfig:
        return HashGridConfig(
            temporal_dim=0,
            num_levels=self.num_levels,
            level_dim=self.features_per_level,
            base_resolution=self.base_res,
            desired_resolution=self.max_res,
            log2_hashmap_size=self.log2_hashmap_size,
            hash_scheme="zline",
        )


def field_mlp_dims(cfg: NerfactoFieldConfig) -> dict:
    """{name: (in, hidden, hidden layers, out)} of the field's MLPs."""
    in_dim_color = cfg.geo_feat_dim + cfg.sh_degree**2
    if cfg.use_appearance_embedding:
        in_dim_color += cfg.appearance_embedding_dim
    dims = {
        "mlp_base": (cfg.num_levels * cfg.features_per_level, cfg.hidden_dim,
                     cfg.num_layers - 1, 1 + cfg.geo_feat_dim),
        "mlp_head": (in_dim_color, cfg.hidden_dim_color,
                     cfg.num_layers_color - 1, 3),
    }
    if cfg.use_pred_normals:
        dims["mlp_pred_normals"] = (cfg.geo_feat_dim + 3, 64, 2, 3)
    return dims


def init_nerfacto_field(cfg: NerfactoFieldConfig,
                        generator: Optional[torch.Generator] = None,
                        device=None) -> dict:
    params = {"grid": init_hash_grid(cfg.grid, generator, device)}
    dims = field_mlp_dims(cfg)
    params["mlp_base"] = init_mlp(*dims["mlp_base"], generator=generator,
                                  device=device)
    if cfg.use_appearance_embedding:
        params["appearance_embedding"] = torch.randn(
            (max(cfg.num_images, 1), cfg.appearance_embedding_dim),
            generator=generator).to(device)
    params["mlp_head"] = init_mlp(*dims["mlp_head"], generator=generator,
                                  device=device)
    if cfg.use_pred_normals:
        params["mlp_pred_normals"] = init_mlp(
            *dims["mlp_pred_normals"], generator=generator, device=device)
    return params


def _normalize(cfg, positions: torch.Tensor, aabb: torch.Tensor) -> torch.Tensor:
    """World -> [0, 1]^3 grid coordinates: the cube contraction, then
    (p + 2) / 4; or the scene box's own normalisation."""
    if cfg.disable_scene_contraction:
        return SceneBox.get_normalized_positions(positions, aabb)
    return (scene_contraction(positions) + 2.0) / 4.0


def nerfacto_density(
    cfg: NerfactoFieldConfig, params: dict, aabb: torch.Tensor,
    positions: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Density [M] and geo features [M, geo_feat_dim] at world positions
    [M, 3]."""
    pts = _normalize(cfg, positions, aabb)
    feats = hash_grid_encode(cfg.grid, params["grid"], pts)
    out = mlp_apply(params["mlp_base"], feats, activation="relu")
    return trunc_exp(out[..., 0]), out[..., 1:]


def nerfacto_rgb(
    cfg: NerfactoFieldConfig,
    params: dict,
    geo_feats: torch.Tensor,
    directions: torch.Tensor,
    camera_indices: Optional[torch.Tensor],
    train: bool = True,
) -> torch.Tensor:
    """Colour [M, 3] from SH-encoded directions, geo features and the
    appearance embedding: the camera's row in training; outside it the
    mean row (``use_average_appearance_embedding``) or zeros."""
    parts = [components_from_spherical_harmonics(cfg.sh_degree, directions),
             geo_feats]
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


def nerfacto_pred_normals(cfg: NerfactoFieldConfig, params: dict,
                          geo_feats: torch.Tensor, positions: torch.Tensor
                          ) -> torch.Tensor:
    """Predicted normals [M, 3]: the ``mlp_pred_normals`` head over world
    positions [M, 3] and geo features, scaled to unit length (+ 1e-10)."""
    h = torch.cat([positions, geo_feats], dim=-1)
    n = mlp_apply(params["mlp_pred_normals"], h, activation="relu")
    return n / (torch.linalg.norm(n, dim=-1, keepdim=True) + 1e-10)


def nerfacto_normals(cfg: NerfactoFieldConfig, params: dict,
                     aabb: torch.Tensor, positions: torch.Tensor
                     ) -> torch.Tensor:
    """Density-gradient normals [M, 3]: minus the gradient of the density's
    sum with respect to the positions, scaled to unit length (+ 1e-10).

    The density is evaluated again on a detached copy of the positions and
    of the params (the JAX package's ``jax.grad`` of it takes the positions'
    gradient alone), with grad enabled locally, so that a render's no_grad
    computes it too; the normals carry no gradient (both losses that read
    them stop it)."""
    # the density reads the grid and the base MLP only
    detached = {name: _detach(params[name]) for name in ("grid", "mlp_base")}
    with torch.enable_grad():
        p = positions.detach().requires_grad_(True)
        density, _ = nerfacto_density(cfg, detached, aabb, p)
        g, = torch.autograd.grad(density.sum(), p)
    return -g / (torch.linalg.norm(g, dim=-1, keepdim=True) + 1e-10)


def _detach(tree):
    if isinstance(tree, dict):
        return {k: _detach(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_detach(v) for v in tree]
    return tree.detach()


# ---------------------------------------------------------------------------
# proposal density field
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class HashMLPDensityFieldConfig:
    num_layers: int = 2
    hidden_dim: int = 64
    use_linear: bool = False
    num_levels: int = 8
    max_res: int = 1024
    base_res: int = 16
    log2_hashmap_size: int = 18
    features_per_level: int = 2
    disable_scene_contraction: bool = False

    @property
    def grid(self) -> HashGridConfig:
        return HashGridConfig(
            temporal_dim=0,
            num_levels=self.num_levels,
            level_dim=self.features_per_level,
            base_resolution=self.base_res,
            desired_resolution=self.max_res,
            log2_hashmap_size=self.log2_hashmap_size,
            hash_scheme="zline",
        )


def proposal_mlp_dims(cfg: HashMLPDensityFieldConfig) -> tuple:
    """(in, hidden, hidden layers, out) of the density MLP."""
    return (cfg.num_levels * cfg.features_per_level, cfg.hidden_dim,
            0 if cfg.use_linear else cfg.num_layers - 1, 1)


def init_hash_density_field(cfg: HashMLPDensityFieldConfig,
                            generator: Optional[torch.Generator] = None,
                            device=None) -> dict:
    return {
        "grid": init_hash_grid(cfg.grid, generator, device),
        "mlp": init_mlp(*proposal_mlp_dims(cfg), generator=generator,
                        device=device),
    }


def hash_density_field_density(
    cfg: HashMLPDensityFieldConfig, params: dict, aabb: torch.Tensor,
    positions: torch.Tensor,
) -> torch.Tensor:
    """Density [M] at world positions [M, 3]."""
    pts = _normalize(cfg, positions, aabb)
    feats = hash_grid_encode(cfg.grid, params["grid"], pts)
    act = "none" if cfg.use_linear else "relu"
    return trunc_exp(mlp_apply(params["mlp"], feats, activation=act)[..., 0])
