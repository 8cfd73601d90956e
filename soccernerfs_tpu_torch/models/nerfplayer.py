"""The full NeRFPlayer model (counterpart of
soccernerfs_tpu/models/nerfplayer.py): the decomposition field
(fields/nerfplayer.py) behind two temporal hash-grid proposal fields (those
of models/nerfplayer_nerfacto.py, whose proposal sampling and schedules it
shares); losses rgb, interlevel, distortion, the temporal TV averaged over
the field's two temporal grids and the proposal grids, and the probability
regulariser ``(0.01 * P_deform + P_new) * prob_reg_loss_mult`` on the
rendered probabilities.

Randomness comes from explicit draws (``train_draws``): the samplers'
jitters, the random background and one ``index_list`` row per temporal
grid (``tv_grids``).  A batch that carries target depths ("depth_image")
adds the DS-NeRF depth loss, weighted by ``depth_weight``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch

from soccernerfs_tpu_torch.fields.nerfplayer import (
    NerfplayerFieldConfig,
    init_nerfplayer_field,
    nerfplayer_density,
    nerfplayer_rgb,
    nerfplayer_temporal_tv,
)
from soccernerfs_tpu_torch.fields.nerfplayer_nerfacto import init_temporal_density_field
from soccernerfs_tpu_torch.models import nerfplayer_nerfacto as _npn
from soccernerfs_tpu_torch.models.instant_ngp import background_for
from soccernerfs_tpu_torch.models.kplanes import (  # noqa: F401  (protocol)
    host_static_kwargs,
    proposal_anneal,
    sample_counts,
)
from soccernerfs_tpu_torch.models.nerfplayer_nerfacto import (  # noqa: F401
    get_metrics_dict,
    proposal_samples,
)
from soccernerfs_tpu_torch.ops import losses as L
from soccernerfs_tpu_torch.ops.hash_grid import temporal_tables, temporal_tv_loss
from soccernerfs_tpu_torch.ops.rendering import (
    random_background,
    render_accumulation,
    render_decomposition,
    render_depth,
    render_rgb,
)

# render_camera's outputs of this model
RENDER_OUTPUTS = ("rgb", "depth", "accumulation", "probs")


@dataclass(frozen=True)
class Config:
    """NeRFPlayer model config; field names and defaults are the JAX
    package's (its ``models/nerfplayer.Config``)."""

    near_plane: float = 0.05
    far_plane: float = 1000.0
    train_background_color: str = "random"
    eval_background_color: str = "white"
    num_levels: int = 16
    features_per_level: int = 2
    log2_hashmap_size: int = 17
    temporal_dim: int = 64
    num_proposal_samples_per_ray: Tuple[int, ...] = (256, 96)
    num_nerf_samples_per_ray: int = 48
    proposal_update_every: int = 5
    proposal_warmup: int = 5000
    num_proposal_iterations: int = 2
    use_same_proposal_network: bool = False
    proposal_net_args_list: Tuple = (
        {"hidden_dim": 16, "temporal_dim": 32, "log2_hashmap_size": 17,
         "num_levels": 5, "max_res": 64},
        {"hidden_dim": 16, "temporal_dim": 32, "log2_hashmap_size": 17,
         "num_levels": 5, "max_res": 256},
    )
    disable_viewing_dependent: bool = True
    interlevel_loss_mult: float = 1.0
    distortion_loss_mult: float = 1e-3
    temporal_tv_weight: float = 1.0
    depth_weight: float = 0.05
    is_euclidean_depth: bool = True
    depth_sigma: float = 0.01
    should_decay_sigma: bool = False
    starting_depth_sigma: float = 0.2
    sigma_decay_rate: float = 0.99985
    depth_loss_type: str = "ds_nerf"
    prob_reg_loss_mult: float = 0.0001
    use_proposal_weight_anneal: bool = True
    proposal_weights_anneal_slope: float = 10.0
    proposal_weights_anneal_max_num_iters: int = 1000
    use_single_jitter: bool = True
    disable_scene_contraction: bool = False
    detached_inputs: bool = True
    eval_num_rays_per_chunk: int = 1 << 15

    # tuples keep the config hashable; the proposal fields are
    # nerfplayer-nerfacto's
    __post_init__ = _npn.Config.__post_init__
    density_field_configs = _npn.Config.density_field_configs

    def field_config(self, num_images: int = 0) -> NerfplayerFieldConfig:
        return NerfplayerFieldConfig(
            temporal_dim=self.temporal_dim,
            num_levels=self.num_levels,
            features_per_level=self.features_per_level,
            log2_hashmap_size=self.log2_hashmap_size,
            disable_viewing_dependent=self.disable_viewing_dependent,
            disable_scene_contraction=self.disable_scene_contraction,
            num_images=num_images,
            detached_inputs=self.detached_inputs,
        )


def init(cfg: Config, num_train_data: int = 0,
         generator: Optional[torch.Generator] = None, device=None) -> dict:
    """Param dict {"fields": ..., "proposal_networks": {"proposal_i": ...}}
    in the JAX package's layout."""
    fields = init_nerfplayer_field(cfg.field_config(num_train_data),
                                   generator=generator, device=device)
    prop_params = {}
    for idx, dcfg in cfg.density_field_configs():
        name = f"proposal_{idx}"
        if name not in prop_params:
            prop_params[name] = init_temporal_density_field(
                dcfg, generator=generator, device=device)
    return {"fields": fields, "proposal_networks": prop_params}


def tv_grids(cfg: Config) -> list:
    """The grid configs the temporal TV reads, in the order of its draws:
    the field's newness and decomposition grids, then each distinct
    proposal field's by index."""
    unique = dict(cfg.density_field_configs())
    temporal = cfg.field_config().temporal_grid
    return [temporal, temporal] + [unique[i].grid for i in sorted(unique)]


def train_draws(cfg: Config, num_rays: int, generator: torch.Generator,
                device) -> dict:
    """The draws of one training step, in this order: per level the
    stratified jitter ([N, 1] with a single jitter, else [N, S + 1]); the
    [N, 3] random background (None for a fixed colour); one ``index_list``
    row per grid of ``tv_grids`` (0-d int64 tensors; none without the TV
    loss)."""
    jitters = [
        torch.rand((num_rays, 1 if cfg.use_single_jitter else s + 1),
                   generator=generator, device=device)
        for s in sample_counts(cfg)
    ]
    background = (random_background(num_rays, device, generator)
                  if cfg.train_background_color == "random" else None)
    tv_rows = [
        torch.randint(0, temporal_tables(grid)[3].shape[0], (),
                      generator=generator, device=device)
        for grid in (tv_grids(cfg) if cfg.temporal_tv_weight > 0 else [])
    ]
    return {"jitters": jitters, "background": background, "tv_rows": tv_rows}


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
) -> dict:
    """Forward: rgb [N, 3], accumulation [N], depth [N], the rendered
    component probabilities "probs" [N, 3], prop_depth_i [N],
    directions_norm [N], plus the per-level weights and samples.  The rays
    need times.

    As nerfplayer-nerfacto's (``models/nerfplayer_nerfacto.get_outputs``),
    with the train background ``train_background_color`` and the eval
    background ``eval_background_color``.
    """
    if ray_bundle.times is None:
        raise ValueError("nerfplayer needs ray times")
    color = cfg.train_background_color if train else cfg.eval_background_color
    if train and jitters is None:
        raise ValueError("training needs the jitters and background draws "
                         "(train_draws)")
    n = ray_bundle.num_rays
    bg = background_for(color, n, ray_bundle.origins.device, train, background)
    ray_bundle, ray_samples, weights_list, ray_samples_list = proposal_samples(
        cfg, params, aabb, ray_bundle, train, anneal, train_proposal_networks,
        jitters)

    fcfg = cfg.field_config()
    positions = ray_samples.get_positions()
    s = positions.shape[1]
    density, geo, probs = nerfplayer_density(
        fcfg, params["fields"], aabb, positions.reshape(-1, 3),
        torch.repeat_interleave(ray_samples.times, s))
    flat_dirs = ray_samples.directions[:, None, :].expand(n, s, 3).reshape(-1, 3)
    rgb_samples = nerfplayer_rgb(fcfg, params["fields"], geo,
                                 flat_dirs).reshape(n, s, 3)
    weights = ray_samples.get_weights(density.reshape(n, s))
    weights_list = weights_list + [weights]
    ray_samples_list = ray_samples_list + [ray_samples]

    outputs = {
        "rgb": render_rgb(rgb_samples, weights, background_color=bg,
                          train=train),
        "accumulation": render_accumulation(weights),
        "depth": render_depth(weights, ray_samples),
        "probs": render_decomposition(probs.reshape(n, s, 3), weights),
        "weights_list": weights_list,
        "ray_samples_list": ray_samples_list,
    }
    for i in range(cfg.num_proposal_iterations):
        outputs[f"prop_depth_{i}"] = render_depth(weights_list[i],
                                                  ray_samples_list[i])
    if ray_bundle.directions_norm is not None:
        outputs["directions_norm"] = ray_bundle.directions_norm
    return outputs


def prob_loss(cfg, outputs: dict) -> torch.Tensor:
    """The probability regulariser: ``(0.01 * mean P_deform + mean P_new)
    * prob_reg_loss_mult`` over the batch's rendered probabilities."""
    mean = outputs["probs"].reshape(-1, 3).mean(dim=0)
    return (0.01 * mean[1] + mean[2]) * cfg.prob_reg_loss_mult


def get_loss_dict(cfg: Config, params: dict, outputs: dict, batch: dict,
                  metrics_dict: dict, tv_rows: Optional[Sequence] = None
                  ) -> dict:
    """The training loss dict, in the JAX package's insertion order (the
    total is summed in that order).  ``tv_rows`` are the temporal TV's
    draws, one ``index_list`` row per grid of ``tv_grids`` (train_draws);
    the TV is averaged over those grids."""
    loss_dict = {
        "rgb_loss": L.mse_loss(batch["image"], outputs["rgb"]),
        "interlevel_loss": cfg.interlevel_loss_mult * L.interlevel_loss(
            outputs["weights_list"], outputs["ray_samples_list"]),
        "distortion_loss": cfg.distortion_loss_mult * metrics_dict["distortion"],
    }
    if "depth_image" in batch and cfg.depth_weight > 0:
        loss_dict["depth_loss"] = cfg.depth_weight * metrics_dict["depth_loss"]
    if cfg.temporal_tv_weight > 0:
        unique = dict(cfg.density_field_configs())
        if tv_rows is None or len(tv_rows) != 2 + len(unique):
            raise ValueError(f"the temporal TV takes {2 + len(unique)} "
                             f"index_list rows (tv_grids), got {tv_rows}")
        tv = nerfplayer_temporal_tv(cfg.field_config(), params["fields"],
                                    tv_rows[:2])
        for idx, row in zip(sorted(unique), tv_rows[2:]):
            tv = tv + temporal_tv_loss(
                unique[idx].grid,
                params["proposal_networks"][f"proposal_{idx}"]["grid"], row)
        loss_dict["temporal_tv_loss"] = (tv * cfg.temporal_tv_weight
                                         / (len(unique) + 2))
    loss_dict["prob_loss"] = prob_loss(cfg, outputs)
    return loss_dict
