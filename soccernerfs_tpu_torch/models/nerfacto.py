"""Nerfacto model (counterpart of soccernerfs_tpu/models/nerfacto.py): a
hash-grid field behind two hash-grid proposal fields, scene contraction
and per-camera appearance embeddings.  The same functional protocol as
models/kplanes.py, whose proposal schedules it shares.

Not ported: the normals branch (``predict_normals``, with its orientation
and predicted-normal losses) and the random background; the config raises
when asked for either.
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
    nerfacto_rgb,
)
from soccernerfs_tpu_torch.models.kplanes import (  # noqa: F401  (protocol)
    host_static_kwargs,
    proposal_anneal,
    sample_counts,
)
from soccernerfs_tpu_torch.ops import losses as L
from soccernerfs_tpu_torch.ops.rendering import (
    render_accumulation,
    render_depth,
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
        if self.predict_normals:
            raise NotImplementedError("the normals branch is not ported yet")
        if self.background_color == "random":
            raise NotImplementedError("the random background is not ported "
                                      "for this model")

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


def train_draws(cfg: Config, num_rays: int, generator: torch.Generator,
                device) -> dict:
    """The uniform draws of one training forward: per level the stratified
    jitter, [N, 1] with a single jitter, else [N, S + 1].  The background
    is a fixed colour and takes no draw."""
    return {"jitters": [
        torch.rand((num_rays, 1 if cfg.use_single_jitter else s + 1),
                   generator=generator, device=device)
        for s in sample_counts(cfg)
    ], "background": None}


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
    interlevel and distortion losses read them).

    In training the samplers jitter with ``jitters`` (``train_draws``'
    layout), which training needs; ``background`` is unused (the colour
    is fixed).  ``anneal`` and
    ``train_proposal_networks`` are the step's schedules
    (``proposal_anneal``, ``host_static_kwargs``).  The appearance embedding
    is the ray's camera's in training (``ray_bundle.camera_indices`` index
    the training cameras), the mean or zeros outside it.
    """
    del background
    if ray_bundle.nears is None or ray_bundle.fars is None:
        n = ray_bundle.num_rays
        dev = ray_bundle.origins.device
        ray_bundle = ray_bundle.replace(
            nears=torch.full((n,), cfg.near_plane, device=dev),
            fars=torch.full((n,), cfg.far_plane, device=dev))
    if train and jitters is None:
        raise ValueError("training needs the jitters draws (train_draws)")

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
    density, geo = nerfacto_density(fcfg, params["fields"], aabb,
                                    positions.reshape(-1, 3))
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
                          background_color=cfg.background_color, train=train),
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
    total is summed in that order)."""
    return {
        "rgb_loss": L.mse_loss(batch["image"], outputs["rgb"]),
        "interlevel_loss": cfg.interlevel_loss_mult * L.interlevel_loss(
            outputs["weights_list"], outputs["ray_samples_list"]),
        "distortion_loss": cfg.distortion_loss_mult * metrics_dict["distortion"],
    }
