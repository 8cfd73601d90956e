"""K-Planes model (counterpart of soccernerfs_tpu/models/kplanes.py), eval.

Proposal-samples rays with the density fields, evaluates the main field
and composites rgb / accumulation / depth.  Training (losses, schedules,
the proposal-update gate) comes with the backward kernels.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from soccernerfs_tpu_torch.core.math import intersect_aabb
from soccernerfs_tpu_torch.core.rays import RayBundle, RaySamples
from soccernerfs_tpu_torch.fields.kplanes import (
    KPlanesDensityFieldConfig,
    KPlanesFieldConfig,
    init_kplanes_density_field,
    init_kplanes_field,
    kplanes_density_field_density,
    kplanes_field_forward,
    pack_grids_for_render,
)
from soccernerfs_tpu_torch.ops.rendering import (
    render_accumulation,
    render_depth,
    render_median_rgb,
    render_rgb,
)
from soccernerfs_tpu_torch.ops.samplers import proposal_sample


@dataclass(frozen=True)
class Config:
    """K-Planes model config; field names and defaults are the JAX
    package's (its ``models/kplanes.Config``)."""

    near_plane: float = 0.05
    far_plane: float = 1000.0
    bounded: bool = True
    spacetime_resolution: Tuple[int, ...] = (64, 64, 64, 50)
    feature_dim: int = 32
    multiscale_res: Tuple[int, ...] = (1, 2, 4, 8)
    concat_features_across_scales: bool = True
    linear_decoder: bool = False
    linear_decoder_layers: int = 1
    sigma_net_layers: int = 1
    sigma_net_hidden_dim: int = 64
    rgb_net_layers: int = 2
    rgb_net_hidden_dim: int = 64
    background_color_train: str = "random"
    background_color_eval: str = "last_sample"
    num_proposal_iterations: int = 2
    use_same_proposal_network: bool = False
    proposal_net_args_list: Tuple[Dict, ...] = (
        {"feature_dim": 8, "resolution": (128, 128, 128, 150)},
        {"feature_dim": 8, "resolution": (256, 256, 256, 150)},
    )
    num_nerf_samples_per_ray: int = 48
    num_proposal_samples_per_ray: Tuple[int, ...] = (256, 128)
    use_single_jitter: bool = False
    proposal_warmup: int = 5000
    proposal_update_every: int = 5
    use_proposal_weight_anneal: bool = True
    proposal_weights_anneal_max_num_iters: int = 1000
    proposal_weights_anneal_slope: float = 10.0
    use_appearance_embedding: bool = False
    appearance_embedding_dim: int = 0
    disable_viewing_dependent: bool = False
    loss_coefficients: Tuple[Tuple[str, float], ...] = (
        ("rgb_loss", 1.0),
        ("interlevel_loss", 1.0),
        ("distortion_loss", 0.001),
        ("space_tv_loss", 0.0002),
        ("time_smoothness_loss", 0.001),
        ("sparse_transients_loss", 0.0001),
        ("space_tv_proposal_loss", 0.0002),
        ("time_smoothness_proposal_loss", 0.00001),
        ("sparse_transients_proposal_loss", 0.0001),
        ("depth_loss", 0.05),
    )
    is_euclidean_depth: bool = True
    depth_sigma: float = 0.01
    should_decay_sigma: bool = False
    starting_depth_sigma: float = 0.2
    sigma_decay_rate: float = 0.99985
    depth_loss_type: str = "ds_nerf"
    freeze_time_planes: bool = False
    freeze_space_planes: bool = False
    eval_num_rays_per_chunk: int = 1 << 15

    def __post_init__(self):
        # tuples keep the config hashable
        def freeze(v):
            if isinstance(v, dict):
                return tuple(sorted((k, freeze(x)) for k, x in v.items()))
            if isinstance(v, (list, tuple)):
                return tuple(freeze(x) for x in v)
            return v

        object.__setattr__(
            self, "proposal_net_args_list", freeze(self.proposal_net_args_list)
        )
        if isinstance(self.loss_coefficients, dict):
            object.__setattr__(
                self, "loss_coefficients", tuple(self.loss_coefficients.items())
            )
        for name in ("spacetime_resolution", "multiscale_res",
                     "num_proposal_samples_per_ray"):
            object.__setattr__(self, name, tuple(getattr(self, name)))

    @property
    def has_time(self) -> bool:
        return len(self.spacetime_resolution) == 4

    def field_config(self, num_images: int = 0) -> KPlanesFieldConfig:
        return KPlanesFieldConfig(
            spacetime_resolution=self.spacetime_resolution,
            feat_dim=self.feature_dim,
            multiscale_res=self.multiscale_res,
            concat_features_across_scales=self.concat_features_across_scales,
            linear_decoder=self.linear_decoder,
            linear_decoder_layers=self.linear_decoder_layers,
            use_appearance_embedding=self.use_appearance_embedding,
            appearance_dim=self.appearance_embedding_dim,
            num_images=num_images,
            disable_viewing_dependent=self.disable_viewing_dependent,
            sigma_net_layers=self.sigma_net_layers,
            sigma_net_hidden_dim=self.sigma_net_hidden_dim,
            rgb_net_layers=self.rgb_net_layers,
            rgb_net_hidden_dim=self.rgb_net_hidden_dim,
            bounded=self.bounded,
            freeze_time_planes=self.freeze_time_planes,
            freeze_space_planes=self.freeze_space_planes,
        )

    def density_field_configs(self):
        """[(proposal index, config)] per proposal iteration."""
        n = self.num_proposal_iterations
        arg_list = [dict(a) for a in self.proposal_net_args_list]
        if self.use_same_proposal_network:
            arg_list = arg_list[:1]
            indices = [0] * n
        else:
            indices = [min(i, len(arg_list) - 1) for i in range(n)]
        built = {}
        cfgs = []
        for i in indices:
            if i not in built:
                a = arg_list[i]
                built[i] = KPlanesDensityFieldConfig(
                    resolution=tuple(a["resolution"]),
                    feature_dim=a["feature_dim"],
                    linear_decoder=self.linear_decoder,
                    bounded=self.bounded,
                    freeze_time_planes=self.freeze_time_planes,
                    freeze_space_planes=self.freeze_space_planes,
                )
            cfgs.append((i, built[i]))
        return cfgs


def init(cfg: Config, num_train_data: int = 0,
         generator: Optional[torch.Generator] = None, device=None) -> dict:
    """Param dict {"fields": ..., "proposal_networks": {"proposal_i": ...}}
    in the JAX package's layout."""
    fields = init_kplanes_field(cfg.field_config(num_train_data),
                                generator=generator, device=device)
    prop_params = {}
    for idx, dcfg in cfg.density_field_configs():
        name = f"proposal_{idx}"
        if name not in prop_params:
            prop_params[name] = init_kplanes_density_field(
                dcfg, generator=generator, device=device
            )
    return {"fields": fields, "proposal_networks": prop_params}


def prepare_render_params(cfg: Config, params: dict) -> dict:
    """Stage every plane table (field + proposals) to bf16 once per
    parameter snapshot (fields/kplanes.pack_grids_for_render); whole-image
    rendering reuses them across chunks.  Eval only: the copies carry no
    gradient link to the grids."""
    with torch.no_grad():
        return {
            **params,
            "fields": pack_grids_for_render(params["fields"]),
            "proposal_networks": {
                k: pack_grids_for_render(v)
                for k, v in params["proposal_networks"].items()
            },
        }


def set_nears_and_fars(cfg: Config, ray_bundle: RayBundle, aabb) -> RayBundle:
    """AABB intersection when bounded, constant near/far otherwise."""
    if cfg.bounded:
        nears, fars = intersect_aabb(
            ray_bundle.origins, ray_bundle.directions, aabb, near_plane=0.0
        )
    else:
        n = ray_bundle.num_rays
        dev = ray_bundle.origins.device
        nears = torch.full((n,), cfg.near_plane, device=dev)
        fars = torch.full((n,), cfg.far_plane, device=dev)
    return ray_bundle.replace(nears=nears, fars=fars)


def get_outputs(
    cfg: Config,
    params: dict,
    aabb: torch.Tensor,
    ray_bundle: RayBundle,
    train: bool = False,
) -> dict:
    """Eval forward: rgb [N, 3], accumulation [N], depth [N], median_rgb
    [N, 3], prop_depth_i [N], directions_norm [N], plus the per-level
    weights and samples."""
    if train:
        raise NotImplementedError("the port renders only; training is not ported yet")
    if ray_bundle.nears is None or ray_bundle.fars is None:
        ray_bundle = set_nears_and_fars(cfg, ray_bundle, aabb)

    def make_density_fn(idx, dcfg):
        def density_fn(ray_samples: RaySamples):
            positions = ray_samples.get_positions()  # [N, S, 3]
            n, s = positions.shape[:2]
            times = ray_samples.times
            flat_times = (
                torch.repeat_interleave(times, s)
                if (times is not None and cfg.has_time) else None
            )
            d = kplanes_density_field_density(
                dcfg,
                params["proposal_networks"][f"proposal_{idx}"],
                aabb,
                positions.reshape(-1, 3),
                flat_times,
            )
            return d.reshape(n, s)

        return density_fn

    density_fns = [make_density_fn(i, d) for i, d in cfg.density_field_configs()]
    ray_samples, weights_list, ray_samples_list = proposal_sample(
        ray_bundle,
        density_fns,
        num_proposal_samples_per_ray=cfg.num_proposal_samples_per_ray,
        num_nerf_samples_per_ray=cfg.num_nerf_samples_per_ray,
        initial_spacing="uniform" if cfg.bounded else "piecewise",
    )

    positions = ray_samples.get_positions()
    n, s = positions.shape[:2]
    flat_times = (
        torch.repeat_interleave(ray_samples.times, s)
        if (ray_samples.times is not None and cfg.has_time) else None
    )
    flat_dirs = ray_samples.directions[:, None, :].expand(n, s, 3).reshape(-1, 3)
    flat_cam = (
        torch.repeat_interleave(ray_samples.camera_indices, s)
        if ray_samples.camera_indices is not None else None
    )
    density, rgb_samples = kplanes_field_forward(
        cfg.field_config(),
        params["fields"],
        aabb,
        positions.reshape(-1, 3),
        flat_dirs,
        flat_times,
        flat_cam,
        train=False,
    )
    rgb_samples = rgb_samples.reshape(n, s, 3)
    density = density.reshape(n, s)

    weights = ray_samples.get_weights(density)
    weights_list = weights_list + [weights]
    ray_samples_list = ray_samples_list + [ray_samples]

    outputs = {
        "rgb": render_rgb(rgb_samples, weights,
                          background_color=cfg.background_color_eval),
        "accumulation": render_accumulation(weights),
        "depth": render_depth(weights, ray_samples),
        "median_rgb": render_median_rgb(rgb_samples, weights),
        "weights_list": weights_list,
        "ray_samples_list": ray_samples_list,
    }
    for i in range(cfg.num_proposal_iterations):
        outputs[f"prop_depth_{i}"] = render_depth(weights_list[i],
                                                  ray_samples_list[i])
    if ray_bundle.directions_norm is not None:
        outputs["directions_norm"] = ray_bundle.directions_norm
    return outputs
