"""Nerfacto model (counterpart of soccernerfs_tpu/models/nerfacto.py): a
hash-grid field behind two hash-grid proposal fields, scene contraction
and per-camera appearance embeddings.  The same functional protocol as
models/kplanes.py, whose proposal schedules it shares.

``predict_normals`` adds the density-gradient and the predicted normals
(``normals``, ``pred_normals``) and, in training, the orientation and
predicted-normal losses; a "random" background is a draw of
``train_draws`` in training and ``random_background``'s fixed-seed draw
outside it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch

from soccernerfs_tpu_torch.core.rays import RayBundle, RaySamples
from soccernerfs_tpu_torch.fields.nerfacto import (
    HashMLPDensityFieldConfig,
    NerfactoFieldConfig,
    hash_density_field_density,
    init_hash_density_field,
    init_nerfacto_field,
    nerfacto_density,
    nerfacto_normals,
    nerfacto_pred_normals,
    nerfacto_rgb,
)
from soccernerfs_tpu_torch.models.kplanes import (  # noqa: F401  (protocol)
    host_static_kwargs,
    proposal_anneal,
    sample_counts,
)
from soccernerfs_tpu_torch.ops import losses as L
from soccernerfs_tpu_torch.ops.rendering import (
    random_background,
    render_accumulation,
    render_depth,
    render_normals,
    render_rgb,
)
from soccernerfs_tpu_torch.ops.samplers import proposal_sample


@dataclass(frozen=True)
class Config:
    """Nerfacto model config; field names and defaults are the JAX
    package's (its ``models/nerfacto.Config``)."""

    near_plane: float = 0.05
    far_plane: float = 1000.0
    background_color: str = "black"
    hidden_dim: int = 64
    hidden_dim_color: int = 64
    num_levels: int = 16
    max_res: int = 2048
    log2_hashmap_size: int = 19
    num_proposal_samples_per_ray: Tuple[int, ...] = (256, 96)
    num_nerf_samples_per_ray: int = 48
    proposal_update_every: int = 5
    proposal_warmup: int = 5000
    num_proposal_iterations: int = 2
    use_same_proposal_network: bool = False
    proposal_net_args_list: Tuple = (
        {"hidden_dim": 16, "log2_hashmap_size": 17, "num_levels": 5, "max_res": 128},
        {"hidden_dim": 16, "log2_hashmap_size": 17, "num_levels": 5, "max_res": 256},
    )
    proposal_initial_sampler: str = "piecewise"
    interlevel_loss_mult: float = 1.0
    distortion_loss_mult: float = 0.002
    orientation_loss_mult: float = 0.0001
    pred_normal_loss_mult: float = 0.001
    use_proposal_weight_anneal: bool = True
    use_average_appearance_embedding: bool = True
    proposal_weights_anneal_slope: float = 10.0
    proposal_weights_anneal_max_num_iters: int = 1000
    use_single_jitter: bool = True
    predict_normals: bool = False
    disable_scene_contraction: bool = False
    appearance_embedding_dim: int = 32
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

    def field_config(self, num_images: int = 0) -> NerfactoFieldConfig:
        return NerfactoFieldConfig(
            hidden_dim=self.hidden_dim,
            hidden_dim_color=self.hidden_dim_color,
            num_levels=self.num_levels,
            max_res=self.max_res,
            log2_hashmap_size=self.log2_hashmap_size,
            appearance_embedding_dim=self.appearance_embedding_dim,
            use_average_appearance_embedding=self.use_average_appearance_embedding,
            use_pred_normals=self.predict_normals,
            disable_scene_contraction=self.disable_scene_contraction,
            num_images=num_images,
        )

    def density_field_configs(self):
        """[(proposal index, config)] per proposal iteration."""
        n = self.num_proposal_iterations
        args = [dict(a) for a in self.proposal_net_args_list]
        if self.use_same_proposal_network:
            indices = [0] * n
            args = args[:1]
        else:
            indices = [min(i, len(args) - 1) for i in range(n)]
        built = {}
        for i in indices:
            if i not in built:
                a = dict(args[i])
                a.pop("use_linear", None)
                built[i] = HashMLPDensityFieldConfig(
                    disable_scene_contraction=self.disable_scene_contraction, **a
                )
        return [(i, built[i]) for i in indices]


def init(cfg: Config, num_train_data: int = 0,
         generator: Optional[torch.Generator] = None, device=None) -> dict:
    """Param dict {"fields": ..., "proposal_networks": {"proposal_i": ...}}
    in the JAX package's layout."""
    fields = init_nerfacto_field(cfg.field_config(num_train_data),
                                 generator=generator, device=device)
    prop_params = {}
    for idx, dcfg in cfg.density_field_configs():
        name = f"proposal_{idx}"
        if name not in prop_params:
            prop_params[name] = init_hash_density_field(
                dcfg, generator=generator, device=device)
    return {"fields": fields, "proposal_networks": prop_params}


def render_outputs(cfg: Config) -> tuple:
    """The outputs render_camera returns: rgb, depth and accumulation, and
    the rendered normals and predicted normals with ``predict_normals``."""
    keys = ("rgb", "depth", "accumulation")
    return (*keys, "normals", "pred_normals") if cfg.predict_normals else keys


def train_draws(cfg: Config, num_rays: int, generator: torch.Generator,
                device) -> dict:
    """The uniform draws of one training forward, in this order: per level
    the stratified jitter, [N, 1] with a single jitter, else [N, S + 1];
    the [N, 3] random background (None for a fixed colour)."""
    jitters = [
        torch.rand((num_rays, 1 if cfg.use_single_jitter else s + 1),
                   generator=generator, device=device)
        for s in sample_counts(cfg)
    ]
    background = (random_background(num_rays, device, generator)
                  if cfg.background_color == "random" else None)
    return {"jitters": jitters, "background": background}


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
    interlevel and distortion losses read them); with ``predict_normals``
    also normals and pred_normals [N, 3] and, in training, the per-ray
    orientation and predicted-normal losses.

    In training the samplers jitter with ``jitters`` and a random
    background is ``background`` (both in ``train_draws``' layout), which
    training needs.  Outside training the random background is
    ``background`` when given, else ``random_background``'s fixed-seed
    draw.  ``anneal`` and ``train_proposal_networks`` are the step's
    schedules (``proposal_anneal``, ``host_static_kwargs``).  The
    appearance embedding is the ray's camera's in training
    (``ray_bundle.camera_indices`` index the training cameras), the mean
    or zeros outside it.
    """
    n = ray_bundle.num_rays
    dev = ray_bundle.origins.device
    if ray_bundle.nears is None or ray_bundle.fars is None:
        ray_bundle = ray_bundle.replace(
            nears=torch.full((n,), cfg.near_plane, device=dev),
            fars=torch.full((n,), cfg.far_plane, device=dev))
    random_bg = cfg.background_color == "random"
    if train and (jitters is None or (random_bg and background is None)):
        raise ValueError("training needs the jitters and background draws "
                         "(train_draws)")
    if random_bg and background is None:
        background = random_background(n, dev)

    def make_density_fn(idx, dcfg):
        def density_fn(ray_samples: RaySamples):
            positions = ray_samples.get_positions()  # [N, S, 3]
            d = hash_density_field_density(
                dcfg, params["proposal_networks"][f"proposal_{idx}"], aabb,
                positions.reshape(-1, 3))
            return d.reshape(positions.shape[:2])

        return density_fn

    ray_samples, weights_list, ray_samples_list = proposal_sample(
        ray_bundle,
        [make_density_fn(i, d) for i, d in cfg.density_field_configs()],
        num_proposal_samples_per_ray=cfg.num_proposal_samples_per_ray,
        num_nerf_samples_per_ray=cfg.num_nerf_samples_per_ray,
        initial_spacing=("uniform" if cfg.proposal_initial_sampler == "uniform"
                         else "piecewise"),
        anneal=anneal,
        jitters=jitters if train else None,
        train_proposal_networks=train_proposal_networks,
    )

    fcfg = cfg.field_config()
    positions = ray_samples.get_positions()
    n, s = positions.shape[:2]
    flat_pos = positions.reshape(-1, 3)
    density, geo = nerfacto_density(fcfg, params["fields"], aabb, flat_pos)
    flat_dirs = ray_samples.directions[:, None, :].expand(n, s, 3).reshape(-1, 3)
    flat_cam = (
        torch.repeat_interleave(ray_samples.camera_indices, s)
        if ray_samples.camera_indices is not None else None
    )
    rgb_samples = nerfacto_rgb(fcfg, params["fields"], geo, flat_dirs, flat_cam,
                               train).reshape(n, s, 3)
    density = density.reshape(n, s)

    weights = ray_samples.get_weights(density)
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
    if cfg.predict_normals:
        # the density-gradient normals carry no gradient (both losses stop
        # it); the predicted ones train the head, the geo features and,
        # through the positions, the poses
        normals = nerfacto_normals(fcfg, params["fields"], aabb,
                                   flat_pos).reshape(n, s, 3)
        pred_normals = nerfacto_pred_normals(
            fcfg, params["fields"], geo, flat_pos).reshape(n, s, 3)
        outputs["normals"] = render_normals(normals, weights)
        outputs["pred_normals"] = render_normals(pred_normals, weights)
        if train:
            outputs["rendered_orientation_loss"] = L.orientation_loss(
                weights, normals, ray_bundle.directions)
            outputs["rendered_pred_normal_loss"] = L.pred_normal_loss(
                weights, normals, pred_normals)
    for i in range(cfg.num_proposal_iterations):
        outputs[f"prop_depth_{i}"] = render_depth(weights_list[i],
                                                  ray_samples_list[i])
    if ray_bundle.directions_norm is not None:
        outputs["directions_norm"] = ray_bundle.directions_norm
    return outputs


def get_metrics_dict(cfg: Config, outputs: dict, batch: dict, step: int = 0
                     ) -> dict:
    """PSNR of the batch (outside the autograd graph) and the distortion,
    which the loss dict scales (inside it)."""
    mse = torch.mean((outputs["rgb"].detach() - batch["image"]) ** 2)
    return {
        "psnr": -10.0 * torch.log10(mse),
        "distortion": L.distortion_loss(outputs["weights_list"],
                                        outputs["ray_samples_list"]),
    }


def get_loss_dict(cfg: Config, params: dict, outputs: dict, batch: dict,
                  metrics_dict: dict) -> dict:
    """The training loss dict, in the JAX package's insertion order (the
    total is summed in that order); with ``predict_normals`` the
    orientation and predicted-normal losses, each the mean over the rays
    times its multiplier."""
    loss_dict = {
        "rgb_loss": L.mse_loss(batch["image"], outputs["rgb"]),
        "interlevel_loss": cfg.interlevel_loss_mult * L.interlevel_loss(
            outputs["weights_list"], outputs["ray_samples_list"]),
        "distortion_loss": cfg.distortion_loss_mult * metrics_dict["distortion"],
    }
    if cfg.predict_normals:
        loss_dict["orientation_loss"] = cfg.orientation_loss_mult * torch.mean(
            outputs["rendered_orientation_loss"])
        loss_dict["pred_normal_loss"] = cfg.pred_normal_loss_mult * torch.mean(
            outputs["rendered_pred_normal_loss"])
    return loss_dict
