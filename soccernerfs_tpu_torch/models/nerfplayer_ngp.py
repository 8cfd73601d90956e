"""NeRFPlayer-NGP model (counterpart of
soccernerfs_tpu/models/nerfplayer_ngp.py): the temporal NGP field behind
instant-NGP's occupancy-grid sampler (models/instant_ngp.py, whose
protocol, state and collider it shares), the alive-ray-masked rgb loss,
the temporal TV regulariser, a train and an eval background.

The grid update probes the density at one random time per update (an
explicit draw, ``aux_draws``' "time").  A batch that carries target
depths ("depth_image", 0 where there is none) adds the depth loss: the
L1 of the rendered depth and the empty-space density penalty, weighted by
``depth_weight``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import torch

from soccernerfs_tpu_torch.fields.nerfplayer_ngp import (
    NerfplayerNGPFieldConfig,
    init_nerfplayer_ngp_field,
    nerfplayer_ngp_density,
    nerfplayer_ngp_rgb,
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
from soccernerfs_tpu_torch.ops.hash_grid import temporal_tables, temporal_tv_loss
from soccernerfs_tpu_torch.ops.occupancy import (
    OccupancyGridConfig,
    update_draws,
    update_occupancy_grid,
)
from soccernerfs_tpu_torch.ops.rendering import (
    random_background,
    render_accumulation,
    render_depth,
    render_rgb,
)


@dataclass(frozen=True)
class Config:
    """NeRFPlayer-NGP model config; field names and defaults are the JAX
    package's (its ``models/nerfplayer_ngp.Config``)."""

    temporal_dim: int = 64
    num_levels: int = 16
    features_per_level: int = 2
    log2_hashmap_size: int = 17
    base_resolution: int = 16
    max_res: int = 2048
    temporal_tv_weight: float = 1.0
    depth_weight: float = 0.05
    train_background_color: str = "random"
    eval_background_color: str = "white"
    disable_viewing_dependent: bool = True
    max_num_samples_per_ray: int = 48
    num_probes_per_ray: int = 256
    grid_resolution: int = 128
    contraction_type: str = "aabb"
    cone_angle: float = 0.0
    render_step_size: float = 0.001
    near_plane: float = 0.05
    far_plane: float = 1e3
    use_appearance_embedding: bool = False
    detached_inputs: bool = True
    eval_num_rays_per_chunk: int = 8192

    def field_config(self, num_images: int = 0) -> NerfplayerNGPFieldConfig:
        return NerfplayerNGPFieldConfig(
            temporal_dim=self.temporal_dim,
            num_levels=self.num_levels,
            features_per_level=self.features_per_level,
            base_resolution=self.base_resolution,
            max_res=self.max_res,
            log2_hashmap_size=self.log2_hashmap_size,
            use_appearance_embedding=self.use_appearance_embedding,
            disable_viewing_dependent=self.disable_viewing_dependent,
            contraction_type=self.contraction_type,
            num_images=num_images,
            detached_inputs=self.detached_inputs,
        )

    @property
    def occ(self) -> OccupancyGridConfig:
        return OccupancyGridConfig(resolution=self.grid_resolution)


def init(cfg: Config, num_train_data: int = 0,
         generator: Optional[torch.Generator] = None, device=None) -> dict:
    """Param dict {"fields": ...} in the JAX package's layout."""
    return {"fields": init_nerfplayer_ngp_field(
        cfg.field_config(num_train_data), generator=generator, device=device)}


def aux_draws(cfg: Config, step: int, generator: Optional[torch.Generator],
              device) -> dict:
    """The draws of the grid update at ``step``: "time", a 0-d uniform, the
    time at which the density is probed, then ``update_draws``'."""
    time = torch.rand((), generator=generator, device=device)
    return {"time": time, **update_draws(cfg.occ, step, generator, device)}


def update_aux(cfg: Config, params: dict, aabb: torch.Tensor, step: int,
               aux: dict, generator: Optional[torch.Generator] = None,
               draws: Optional[dict] = None) -> dict:
    """The state after the optimizer step at ``step`` (``params`` are the
    updated ones): on an update step the grid's EMA update at the time
    ``draws["time"]`` (``aux_draws``' layout; drawn from ``generator`` when
    None), else ``aux`` itself."""
    return update_aux_at_a_time(nerfplayer_ngp_density, cfg, params, aabb,
                                step, aux, generator, draws)


def update_aux_at_a_time(density, cfg, params: dict, aabb: torch.Tensor,
                         step: int, aux: dict,
                         generator: Optional[torch.Generator],
                         draws: Optional[dict]) -> dict:
    """``update_aux`` of a temporal occupancy model whose field's
    ``density(field_cfg, params["fields"], aabb, positions, times)``
    returns the density first: the grid probed at the one time
    ``draws["time"]``."""
    if not update_due(cfg, step):
        return aux
    if draws is None:
        draws = aux_draws(cfg, step, generator, aux["occs"].device)
    fcfg = cfg.field_config()

    def density_fn(positions):
        times = draws["time"].expand(positions.shape[0])
        return density(fcfg, params["fields"], aabb, positions, times)[0]

    occs = update_occupancy_grid(cfg.occ, aux["occs"], aabb, density_fn,
                                 cfg.render_step_size, step=step, draws=draws)
    return {**aux, "occs": occs}


def train_draws(cfg: Config, num_rays: int, generator: torch.Generator,
                device) -> dict:
    """The draws of one training step, in this order: the probes'
    stratified jitter ([N, 1], in a list of one); the [N, 3] random
    background (None for a fixed colour); the temporal TV's
    ``index_list`` row (a 0-d int64 tensor in a list; none without the
    TV)."""
    jitter = torch.rand((num_rays, 1), generator=generator, device=device)
    background = (random_background(num_rays, device, generator)
                  if cfg.train_background_color == "random" else None)
    grid = cfg.field_config().grid
    tv_rows = ([torch.randint(0, temporal_tables(grid)[3].shape[0], (),
                              generator=generator, device=device)]
               if cfg.temporal_tv_weight > 0 else [])
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
    """Forward: rgb [N, 3], accumulation [N], depth [N], alive_ray_mask
    [N], num_samples_per_ray [N], the masked densities ("sigmas"), weights,
    samples and valid mask, and directions_norm [N].  The rays need times.

    As instant-NGP's (``models/instant_ngp.get_outputs``), with the train
    background ``train_background_color`` and the eval background
    ``eval_background_color``.
    """
    del anneal, train_proposal_networks
    if ray_bundle.times is None:
        raise ValueError("nerfplayer-ngp needs ray times")
    ray_bundle, ray_samples, valid = occupancy_samples(
        cfg, ray_bundle, aabb, occ_binary, jitters, train)
    n, s = valid.shape
    fcfg = cfg.field_config()
    positions = ray_samples.get_positions()
    density, geo = nerfplayer_ngp_density(
        fcfg, params["fields"], aabb, positions.reshape(-1, 3),
        torch.repeat_interleave(ray_samples.times, s))
    flat_dirs = ray_samples.directions[:, None, :].expand(n, s, 3).reshape(-1, 3)
    flat_cam = (torch.repeat_interleave(ray_samples.camera_indices, s)
                if ray_samples.camera_indices is not None else None)
    rgb_samples = nerfplayer_ngp_rgb(fcfg, params["fields"], geo, flat_dirs,
                                     flat_cam, train).reshape(n, s, 3)
    # 0 at invalid samples, also where their density overflowed to inf
    sigmas = torch.where(valid, density.reshape(n, s), 0.0)
    weights = ray_samples.get_weights(sigmas)
    color = cfg.train_background_color if train else cfg.eval_background_color
    bg = background_for(color, n, ray_bundle.origins.device, train, background)
    outputs = {
        "rgb": render_rgb(rgb_samples, weights, background_color=bg, train=train),
        "accumulation": render_accumulation(weights),
        "depth": render_depth(weights, ray_samples),
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


def depth_l1(outputs: dict, depth_gt: torch.Tensor) -> torch.Tensor:
    """Mean |rendered depth - target| over the rays with a target (not 0)."""
    dmask = depth_gt != 0
    l1 = torch.sum(torch.where(dmask, torch.abs(outputs["depth"] - depth_gt), 0.0))
    return l1 / torch.clamp(dmask.sum(), min=1).float()


# the empty-space penalty's margin in front of the target: the normalised
# scene's extent / 128, as the JAX version takes it
EMPTY_SPACE_MARGIN = 3.0 / 128.0


def depth_loss(outputs: dict, depth_gt: torch.Tensor) -> torch.Tensor:
    """``depth_l1`` plus 1e-2 times the mean squared density of the valid
    samples more than ``EMPTY_SPACE_MARGIN`` in front of the target."""
    steps = outputs["ray_samples"].midpoints()
    gt = depth_gt[:, None]
    front = (gt - steps > EMPTY_SPACE_MARGIN) & (gt != 0) & outputs["valid"]
    empty = (torch.sum(torch.where(front, outputs["sigmas"] ** 2, 0.0))
             / torch.clamp(front.sum(), min=1).float())
    return depth_l1(outputs, depth_gt) + empty * 1e-2


def get_loss_dict(cfg: Config, params: dict, outputs: dict, batch: dict,
                  metrics_dict: Optional[dict] = None,
                  tv_rows: Optional[Sequence] = None) -> Dict[str, torch.Tensor]:
    """The training loss dict: the alive-ray-masked rgb loss, then the
    temporal TV of the field's grid at ``tv_rows[0]`` (train_draws),
    scaled by its weight; with a batch that carries "depth_image", the
    depth loss between them."""
    loss_dict = {"rgb_loss": masked_rgb_loss(outputs, batch)}
    if "depth_image" in batch and cfg.depth_weight > 0:
        loss_dict["depth_loss"] = (depth_loss(outputs, batch["depth_image"])
                                   * cfg.depth_weight)
    if cfg.temporal_tv_weight > 0:
        if tv_rows is None or len(tv_rows) != 1:
            raise ValueError(f"the temporal TV takes 1 index_list row "
                             f"(train_draws), got {tv_rows}")
        loss_dict["temporal_tv_loss"] = temporal_tv_loss(
            cfg.field_config().grid, params["fields"]["grid"], tv_rows[0]
        ) * cfg.temporal_tv_weight
    return loss_dict
