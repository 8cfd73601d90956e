"""NeRFPlayer-NGP-complete (counterpart of
soccernerfs_tpu/models/nerfplayer_ngp_complete.py): the full decomposition
field (fields/nerfplayer.py) behind instant-NGP's occupancy-grid sampler
(models/instant_ngp.py, whose protocol, state and collider it shares), the
alive-ray-masked rgb loss, the temporal TV of the field's two temporal
grids and the probability regulariser.

The grid update probes the full decomposition density at one random time
per update (``aux_draws``' "time"), under ``no_grad``, in chunks of
``ops.occupancy.PROBE_CHUNK`` cells.  A batch that carries target depths
("depth_image", 0 where there is none) adds the L1 of the rendered depth,
weighted by ``depth_weight``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import torch

from soccernerfs_tpu_torch.fields.nerfplayer import (
    NerfplayerFieldConfig,
    init_nerfplayer_field,
    nerfplayer_density,
    nerfplayer_rgb,
    nerfplayer_temporal_tv,
)
from soccernerfs_tpu_torch.models.instant_ngp import (  # noqa: F401  (protocol)
    background_for,
    eval_kwargs,
    get_metrics_dict,
    host_static_kwargs,
    init_aux,
    masked_rgb_loss,
    occupancy_samples,
    proposal_anneal,
    schedules,
    update_due,
)
from soccernerfs_tpu_torch.models.nerfplayer import RENDER_OUTPUTS, prob_loss  # noqa: F401
from soccernerfs_tpu_torch.models.nerfplayer_ngp import (  # noqa: F401
    aux_draws,
    depth_l1,
    update_aux_at_a_time,
)
from soccernerfs_tpu_torch.ops.hash_grid import temporal_tables
from soccernerfs_tpu_torch.ops.occupancy import OccupancyGridConfig
from soccernerfs_tpu_torch.ops.rendering import (
    random_background,
    render_accumulation,
    render_decomposition,
    render_depth,
    render_rgb,
)


@dataclass(frozen=True)
class Config:
    """NeRFPlayer-NGP-complete model config; field names and defaults are
    the JAX package's (its ``models/nerfplayer_ngp_complete.Config``)."""

    temporal_dim: int = 64
    num_levels: int = 16
    features_per_level: int = 2
    log2_hashmap_size: int = 17
    base_resolution: int = 16
    temporal_tv_weight: float = 1.0
    depth_weight: float = 0.05
    prob_reg_loss_mult: float = 0.0001
    train_background_color: str = "random"
    eval_background_color: str = "white"
    disable_viewing_dependent: bool = True
    max_num_samples_per_ray: int = 48
    num_probes_per_ray: int = 256
    grid_resolution: int = 128
    contraction_type: str = "aabb"
    render_step_size: float = 0.001
    near_plane: float = 0.05
    far_plane: float = 1e3
    detached_inputs: bool = True
    eval_num_rays_per_chunk: int = 8192

    def field_config(self, num_images: int = 0) -> NerfplayerFieldConfig:
        return NerfplayerFieldConfig(
            temporal_dim=self.temporal_dim,
            num_levels=self.num_levels,
            features_per_level=self.features_per_level,
            base_resolution=self.base_resolution,
            log2_hashmap_size=self.log2_hashmap_size,
            disable_viewing_dependent=self.disable_viewing_dependent,
            disable_scene_contraction=self.contraction_type == "aabb",
            num_images=num_images,
            detached_inputs=self.detached_inputs,
        )

    @property
    def occ(self) -> OccupancyGridConfig:
        return OccupancyGridConfig(resolution=self.grid_resolution)


def init(cfg: Config, num_train_data: int = 0,
         generator: Optional[torch.Generator] = None, device=None) -> dict:
    """Param dict {"fields": ...} in the JAX package's layout."""
    return {"fields": init_nerfplayer_field(
        cfg.field_config(num_train_data), generator=generator, device=device)}


def update_aux(cfg: Config, params: dict, aabb: torch.Tensor, step: int,
               aux: dict, generator: Optional[torch.Generator] = None,
               draws: Optional[dict] = None) -> dict:
    """The state after the optimizer step at ``step`` (``params`` are the
    updated ones): on an update step the grid's EMA update of the
    decomposition density at the time ``draws["time"]`` (``aux_draws``'
    layout; drawn from ``generator`` when None), else ``aux`` itself."""
    return update_aux_at_a_time(nerfplayer_density, cfg, params, aabb, step,
                                aux, generator, draws)


def train_draws(cfg: Config, num_rays: int, generator: torch.Generator,
                device) -> dict:
    """The draws of one training step, in this order: the probes'
    stratified jitter ([N, 1], in a list of one); the [N, 3] random
    background (None for a fixed colour); the temporal TV's ``index_list``
    rows of the newness and the decomposition grid (0-d int64 tensors;
    none without the TV)."""
    jitter = torch.rand((num_rays, 1), generator=generator, device=device)
    background = (random_background(num_rays, device, generator)
                  if cfg.train_background_color == "random" else None)
    rows = temporal_tables(cfg.field_config().temporal_grid)[3].shape[0]
    tv_rows = ([torch.randint(0, rows, (), generator=generator, device=device)
                for _ in range(2)] if cfg.temporal_tv_weight > 0 else [])
    return {"jitters": [jitter], "background": background, "tv_rows": tv_rows}


def get_outputs(
    cfg: Config,
    params: dict,
    aabb: torch.Tensor,
    ray_bundle,
    train: bool = False,
    anneal: float = 1.0,
    train_proposal_networks: bool = True,
    jitters: Optional[Sequence[torch.Tensor]] = None,
    background: Optional[torch.Tensor] = None,
    occ_binary: Optional[torch.Tensor] = None,
) -> dict:
    """Forward: rgb [N, 3], accumulation [N], depth [N], the rendered
    component probabilities "probs" [N, 3], alive_ray_mask [N],
    num_samples_per_ray [N], the masked densities ("sigmas"), weights,
    samples and valid mask, and directions_norm [N].  The rays need times.

    As NeRFPlayer-NGP's (``models/nerfplayer_ngp.get_outputs``) with the
    decomposition field.
    """
    del anneal, train_proposal_networks
    if ray_bundle.times is None:
        raise ValueError("nerfplayer-ngp-complete needs ray times")
    ray_bundle, ray_samples, valid = occupancy_samples(
        cfg, ray_bundle, aabb, occ_binary, jitters, train)
    n, s = valid.shape
    fcfg = cfg.field_config()
    positions = ray_samples.get_positions()
    density, geo, probs = nerfplayer_density(
        fcfg, params["fields"], aabb, positions.reshape(-1, 3),
        torch.repeat_interleave(ray_samples.times, s))
    flat_dirs = ray_samples.directions[:, None, :].expand(n, s, 3).reshape(-1, 3)
    rgb_samples = nerfplayer_rgb(fcfg, params["fields"], geo,
                                 flat_dirs).reshape(n, s, 3)
    # 0 at invalid samples, also where their density overflowed to inf
    sigmas = torch.where(valid, density.reshape(n, s), 0.0)
    weights = ray_samples.get_weights(sigmas)
    color = cfg.train_background_color if train else cfg.eval_background_color
    bg = background_for(color, n, ray_bundle.origins.device, train, background)
    outputs = {
        "rgb": render_rgb(rgb_samples, weights, background_color=bg, train=train),
        "accumulation": render_accumulation(weights),
        "depth": render_depth(weights, ray_samples),
        "probs": render_decomposition(probs.reshape(n, s, 3), weights),
        "alive_ray_mask": torch.any(valid, dim=-1),
        "num_samples_per_ray": torch.sum(valid, dim=-1),
        "sigmas": sigmas,
        "weights": weights,
        "ray_samples": ray_samples,
        "valid": valid,
    }
    if ray_bundle.directions_norm is not None:
        outputs["directions_norm"] = ray_bundle.directions_norm
    return outputs


def get_loss_dict(cfg: Config, params: dict, outputs: dict, batch: dict,
                  metrics_dict: Optional[dict] = None,
                  tv_rows: Optional[Sequence] = None) -> Dict[str, torch.Tensor]:
    """The training loss dict: the alive-ray-masked rgb loss, the temporal
    TV of the newness and decomposition grids at ``tv_rows`` (train_draws),
    averaged over the two and scaled by its weight, and the probability
    regulariser; with a batch that carries "depth_image", the depth L1
    after the rgb loss."""
    loss_dict = {"rgb_loss": masked_rgb_loss(outputs, batch)}
    if "depth_image" in batch and cfg.depth_weight > 0:
        loss_dict["depth_loss"] = (depth_l1(outputs, batch["depth_image"])
                                   * cfg.depth_weight)
    if cfg.temporal_tv_weight > 0:
        if tv_rows is None or len(tv_rows) != 2:
            raise ValueError(f"the temporal TV takes 2 index_list rows "
                             f"(train_draws), got {tv_rows}")
        loss_dict["temporal_tv_loss"] = (
            nerfplayer_temporal_tv(cfg.field_config(), params["fields"], tv_rows)
            * cfg.temporal_tv_weight / 2.0)
    loss_dict["prob_loss"] = prob_loss(cfg, outputs)
    return loss_dict
