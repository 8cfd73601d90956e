"""NeRFPlayer-nerfacto model (counterpart of
soccernerfs_tpu/models/nerfplayer_nerfacto.py): a temporal hash-grid field
behind two temporal hash-grid proposal fields, nerfacto's losses and the
temporal TV regulariser over all three grids.  The same functional
protocol as models/kplanes.py, whose proposal schedules it shares.

Randomness comes from explicit draws (``train_draws``): the samplers'
jitters, the random background and one ``index_list`` row per grid for
the temporal TV.  A batch that carries target depths ("depth_image")
adds the DS-NeRF depth loss, weighted by ``depth_weight``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch

from soccernerfs_tpu_torch.core.math import intersect_aabb
from soccernerfs_tpu_torch.core.rays import RayBundle, RaySamples
from soccernerfs_tpu_torch.fields.nerfplayer_nerfacto import (
    NerfplayerNerfactoFieldConfig,
    TemporalHashMLPDensityFieldConfig,
    init_nerfplayer_nerfacto_field,
    init_temporal_density_field,
    nerfplayer_nerfacto_density,
    nerfplayer_nerfacto_rgb,
    temporal_density_field_density,
)
from soccernerfs_tpu_torch.models.kplanes import depth_metric
from soccernerfs_tpu_torch.models.kplanes import (  # noqa: F401  (protocol)
    host_static_kwargs,
    proposal_anneal,
    sample_counts,
)
from soccernerfs_tpu_torch.ops import losses as L
from soccernerfs_tpu_torch.ops.hash_grid import temporal_tables, temporal_tv_loss
from soccernerfs_tpu_torch.ops.rendering import (
    random_background,
    render_accumulation,
    render_depth,
    render_rgb,
)
from soccernerfs_tpu_torch.ops.samplers import proposal_sample


@dataclass(frozen=True)
class Config:
    """NeRFPlayer-nerfacto model config; field names and defaults are the
    JAX package's (its ``models/nerfplayer_nerfacto.Config``)."""

    near_plane: float = 0.05
    far_plane: float = 1000.0
    background_color: str = "random"
    num_levels: int = 16
    features_per_level: int = 2
    log2_hashmap_size: int = 18
    temporal_dim: int = 64
    hidden_dim: int = 64
    hidden_dim_color: int = 64
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
    proposal_initial_sampler: str = "piecewise"
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
    use_proposal_weight_anneal: bool = True
    proposal_weights_anneal_slope: float = 10.0
    proposal_weights_anneal_max_num_iters: int = 1000
    use_single_jitter: bool = True
    disable_scene_contraction: bool = False
    disable_viewing_dependent: bool = False
    appearance_embedding_dim: int = 32
    use_average_appearance_embedding: bool = True
    detached_inputs: bool = True
    eval_num_rays_per_chunk: int = 1 << 15

    def __post_init__(self):
        # tuples keep the config hashable
        def freeze(v):
            if isinstance(v, dict):
                return tuple(sorted((k, freeze(x)) for k, x in v.items()))
            if isinstance(v, (list, tuple)):
                return tuple(freeze(x) for x in v)
            return v

        object.__setattr__(self, "proposal_net_args_list",
                           freeze(self.proposal_net_args_list))
        object.__setattr__(self, "num_proposal_samples_per_ray",
                           tuple(self.num_proposal_samples_per_ray))

    def field_config(self, num_images: int = 0) -> NerfplayerNerfactoFieldConfig:
        return NerfplayerNerfactoFieldConfig(
            hidden_dim=self.hidden_dim,
            hidden_dim_color=self.hidden_dim_color,
            temporal_dim=self.temporal_dim,
            num_levels=self.num_levels,
            features_per_level=self.features_per_level,
            log2_hashmap_size=self.log2_hashmap_size,
            appearance_embedding_dim=self.appearance_embedding_dim,
            use_average_appearance_embedding=self.use_average_appearance_embedding,
            disable_viewing_dependent=self.disable_viewing_dependent,
            disable_scene_contraction=self.disable_scene_contraction,
            num_images=num_images,
            detached_inputs=self.detached_inputs,
        )

    def density_field_configs(self):
        """[(proposal index, config)] per proposal iteration."""
        n = self.num_proposal_iterations
        args = [dict(a) for a in self.proposal_net_args_list]
        indices = ([0] * n if self.use_same_proposal_network
                   else [min(i, len(args) - 1) for i in range(n)])
        built = {}
        for i in indices:
            if i not in built:
                built[i] = TemporalHashMLPDensityFieldConfig(
                    disable_scene_contraction=self.disable_scene_contraction,
                    detached_inputs=self.detached_inputs, **dict(args[i]))
        return [(i, built[i]) for i in indices]


def init(cfg: Config, num_train_data: int = 0,
         generator: Optional[torch.Generator] = None, device=None) -> dict:
    """Param dict {"fields": ..., "proposal_networks": {"proposal_i": ...}}
    in the JAX package's layout."""
    fields = init_nerfplayer_nerfacto_field(cfg.field_config(num_train_data),
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
    the field's, then each distinct proposal field's by index."""
    unique = dict(cfg.density_field_configs())
    return [cfg.field_config().grid] + [unique[i].grid for i in sorted(unique)]


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
                  if cfg.background_color == "random" else None)
    tv_rows = [
        torch.randint(0, temporal_tables(grid)[3].shape[0], (),
                      generator=generator, device=device)
        for grid in (tv_grids(cfg) if cfg.temporal_tv_weight > 0 else [])
    ]
    return {"jitters": jitters, "background": background, "tv_rows": tv_rows}


def proposal_samples(cfg, params: dict, aabb: torch.Tensor,
                     ray_bundle: RayBundle, train: bool, anneal: float,
                     train_proposal_networks: bool,
                     jitters: Optional[Sequence[torch.Tensor]]):
    """The field's samples of a temporal proposal model: nears and fars
    from the scene box when contraction is off, else the config's planes;
    then the proposal sampler over the temporal proposal fields
    (``params["proposal_networks"]``), jittered by ``jitters`` in
    training.  Returns (the rays with nears and fars, the field's
    RaySamples, the proposal levels' weights and samples)."""
    n = ray_bundle.num_rays
    dev = ray_bundle.origins.device
    if ray_bundle.nears is None or ray_bundle.fars is None:
        if cfg.disable_scene_contraction:
            nears, fars = intersect_aabb(ray_bundle.origins,
                                         ray_bundle.directions, aabb)
        else:
            nears = torch.full((n,), cfg.near_plane, device=dev)
            fars = torch.full((n,), cfg.far_plane, device=dev)
        ray_bundle = ray_bundle.replace(nears=nears, fars=fars)

    def make_density_fn(idx, dcfg):
        def density_fn(ray_samples: RaySamples):
            positions = ray_samples.get_positions()  # [N, S, 3]
            s = positions.shape[1]
            d = temporal_density_field_density(
                dcfg, params["proposal_networks"][f"proposal_{idx}"], aabb,
                positions.reshape(-1, 3),
                torch.repeat_interleave(ray_samples.times, s))
            return d.reshape(positions.shape[:2])

        return density_fn

    ray_samples, weights_list, ray_samples_list = proposal_sample(
        ray_bundle,
        [make_density_fn(i, d) for i, d in cfg.density_field_configs()],
        num_proposal_samples_per_ray=cfg.num_proposal_samples_per_ray,
        num_nerf_samples_per_ray=cfg.num_nerf_samples_per_ray,
        initial_spacing=("uniform" if cfg.disable_scene_contraction
                         else "piecewise"),
        anneal=anneal,
        jitters=jitters if train else None,
        train_proposal_networks=train_proposal_networks,
    )
    return ray_bundle, ray_samples, weights_list, ray_samples_list


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
    """Forward: rgb [N, 3], accumulation [N], depth [N], prop_depth_i [N],
    directions_norm [N], plus the per-level weights and samples (the
    interlevel and distortion losses read them).  The rays need times.

    Near and far come from the scene box when contraction is off, else
    from the config's planes.  In training the samplers jitter with
    ``jitters`` and the random background is ``background`` (both in
    ``train_draws``' layout), which training needs.  Outside training the
    random background is ``background`` when given, else
    ``random_background``'s fixed-seed draw.  ``anneal`` and
    ``train_proposal_networks`` are the step's schedules.
    """
    if ray_bundle.times is None:
        raise ValueError("nerfplayer-nerfacto needs ray times")
    n = ray_bundle.num_rays
    dev = ray_bundle.origins.device
    random_bg = cfg.background_color == "random"
    if train:
        if jitters is None or (random_bg and background is None):
            raise ValueError("training needs the jitters and background "
                             "draws (train_draws)")
    elif random_bg and background is None:
        background = random_background(n, dev)
    ray_bundle, ray_samples, weights_list, ray_samples_list = proposal_samples(
        cfg, params, aabb, ray_bundle, train, anneal, train_proposal_networks,
        jitters)

    fcfg = cfg.field_config()
    positions = ray_samples.get_positions()
    s = positions.shape[1]
    density, geo = nerfplayer_nerfacto_density(
        fcfg, params["fields"], aabb, positions.reshape(-1, 3),
        torch.repeat_interleave(ray_samples.times, s))
    flat_dirs = ray_samples.directions[:, None, :].expand(n, s, 3).reshape(-1, 3)
    flat_cam = (
        torch.repeat_interleave(ray_samples.camera_indices, s)
        if ray_samples.camera_indices is not None else None
    )
    rgb_samples = nerfplayer_nerfacto_rgb(
        fcfg, params["fields"], geo, flat_dirs, flat_cam, train).reshape(n, s, 3)
    weights = ray_samples.get_weights(density.reshape(n, s))
    weights_list = weights_list + [weights]
    ray_samples_list = ray_samples_list + [ray_samples]

    outputs = {
        "rgb": render_rgb(rgb_samples, weights,
                          background_color=(background if random_bg
                                            else cfg.background_color),
                          train=train),
        "accumulation": render_accumulation(weights),
        "depth": render_depth(weights, ray_samples),
        "weights_list": weights_list,
        "ray_samples_list": ray_samples_list,
    }
    for i in range(cfg.num_proposal_iterations):
        outputs[f"prop_depth_{i}"] = render_depth(weights_list[i],
                                                  ray_samples_list[i])
    if ray_bundle.directions_norm is not None:
        outputs["directions_norm"] = ray_bundle.directions_norm
    return outputs


def get_metrics_dict(cfg: Config, outputs: dict, batch: dict, step: int = 0
                     ) -> dict:
    """PSNR of the batch (outside the autograd graph), the distortion and,
    for a batch that carries "depth_image", the DS-NeRF depth loss at
    ``step`` (inside it: the loss dict scales both)."""
    mse = torch.mean((outputs["rgb"].detach() - batch["image"]) ** 2)
    metrics = {
        "psnr": -10.0 * torch.log10(mse),
        "distortion": L.distortion_loss(outputs["weights_list"],
                                        outputs["ray_samples_list"]),
    }
    if "depth_image" in batch:
        metrics["depth_loss"] = depth_metric(cfg, outputs, batch, step)
    return metrics


def get_loss_dict(cfg: Config, params: dict, outputs: dict, batch: dict,
                  metrics_dict: dict, tv_rows: Optional[Sequence] = None
                  ) -> dict:
    """The training loss dict, in the JAX package's insertion order (the
    total is summed in that order).  ``tv_rows`` are the temporal TV's
    draws, one ``index_list`` row per grid of ``tv_grids`` (train_draws)."""
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
        if tv_rows is None or len(tv_rows) != 1 + len(unique):
            raise ValueError(f"the temporal TV takes {1 + len(unique)} "
                             f"index_list rows (tv_grids), got {tv_rows}")
        tv = temporal_tv_loss(cfg.field_config().grid, params["fields"]["grid"],
                              tv_rows[0])
        for idx, row in zip(sorted(unique), tv_rows[1:]):
            tv = tv + temporal_tv_loss(
                unique[idx].grid,
                params["proposal_networks"][f"proposal_{idx}"]["grid"], row)
        loss_dict["temporal_tv_loss"] = tv * cfg.temporal_tv_weight
    return loss_dict
