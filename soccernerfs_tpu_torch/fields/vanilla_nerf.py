"""Classic NeRF field (counterpart of soccernerfs_tpu/fields/vanilla_nerf.py).

The NeRF-encoded positions through an 8 x 256 base MLP with the encoding
fed in again at the skip (layer 4), a density head (ReLU) and an rgb head
over the base features and the encoded view direction (sigmoid).  With
``use_integrated_encoding`` the position encoding is mip-NeRF's integrated
one over the samples' covariances.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from soccernerfs_tpu_torch.ops.encodings import nerf_encoding
from soccernerfs_tpu_torch.ops.mlp import init_mlp, mlp_apply


@dataclass(frozen=True)
class NeRFFieldConfig:
    """Field names and defaults are the JAX package's: an 8 x 256 base MLP
    with the skip at layer 4, a 2 x 128 rgb head."""

    position_encoding_num_frequencies: int = 10
    position_encoding_max: float = 8.0
    direction_encoding_num_frequencies: int = 4
    direction_encoding_max: float = 4.0
    base_mlp_num_layers: int = 8
    base_mlp_layer_width: int = 256
    skip_connections: Tuple[int, ...] = (4,)
    head_mlp_num_layers: int = 2
    head_mlp_layer_width: int = 128
    use_integrated_encoding: bool = False

    @property
    def pos_dim(self) -> int:
        return 3 * self.position_encoding_num_frequencies * 2

    @property
    def dir_dim(self) -> int:
        return 3 * self.direction_encoding_num_frequencies * 2


def field_mlp_dims(cfg: NeRFFieldConfig) -> Dict[str, tuple]:
    """(in, hidden, hidden layers, out) of each MLP, in the params' order:
    the base MLP split at the skip, then the two heads."""
    width, skip = cfg.base_mlp_layer_width, cfg.skip_connections[0]
    return {
        "mlp_pre": (cfg.pos_dim, width, skip - 1, width),
        "mlp_post": (width + cfg.pos_dim, width,
                     cfg.base_mlp_num_layers - skip - 1, width),
        "density_head": (width, width, 0, 1),
        "rgb_head": (width + cfg.dir_dim, cfg.head_mlp_layer_width,
                     cfg.head_mlp_num_layers - 1, 3),
    }


def init_nerf_field(cfg: NeRFFieldConfig,
                    generator: Optional[torch.Generator] = None,
                    device=None) -> dict:
    return {name: init_mlp(*dims, generator=generator, device=device)
            for name, dims in field_mlp_dims(cfg).items()}


def nerf_field_forward(
    cfg: NeRFFieldConfig,
    params: dict,
    positions: torch.Tensor,
    directions: torch.Tensor,
    covs: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(density [M], rgb [M, 3]) at positions [M, 3] seen along unit
    directions [M, 3]; ``covs`` [M, 3, 3] are read only with
    ``use_integrated_encoding``."""
    pe = nerf_encoding(
        positions, cfg.position_encoding_num_frequencies, 0.0,
        cfg.position_encoding_max,
        covs=covs if cfg.use_integrated_encoding else None)
    h = mlp_apply(params["mlp_pre"], pe, activation="relu",
                  output_activation="relu")
    h = mlp_apply(params["mlp_post"], torch.cat([h, pe], dim=-1),
                  activation="relu", output_activation="relu")
    density = torch.relu(
        mlp_apply(params["density_head"], h, activation="none")[..., 0])
    de = nerf_encoding(directions, cfg.direction_encoding_num_frequencies,
                       0.0, cfg.direction_encoding_max)
    rgb = mlp_apply(params["rgb_head"], torch.cat([h, de], dim=-1),
                    activation="relu", output_activation="sigmoid")
    return density, rgb
