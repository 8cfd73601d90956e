"""Vanilla NeRF model (counterpart of soccernerfs_tpu/models/vanilla_nerf.py).

Coarse uniform samples through a coarse NeRF field, then PDF samples of
the coarse weights merged with the coarse bins (``include_original``)
through a separate fine field; the MSE of both renders.  The registry's
dnerf is this model on D-NeRF data: as in the JAX package there is no
temporal distortion, the times of the rays are not read.

Randomness is explicit (``train_draws``): the coarse sampler's jitter
[N, S + 1] and the PDF sampler's [N, S_fine + 1].  The background is a
fixed colour.  The model has no proposal sampler: it takes the protocol's
proposal schedules (``proposal_anneal``, ``host_static_kwargs``) and
ignores them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import torch

from soccernerfs_tpu_torch.core.rays import RayBundle, RaySamples
from soccernerfs_tpu_torch.fields.vanilla_nerf import (
    NeRFFieldConfig,
    init_nerf_field,
    nerf_field_forward,
)
from soccernerfs_tpu_torch.ops import losses as L
from soccernerfs_tpu_torch.ops.rendering import (
    render_accumulation,
    render_depth,
    render_rgb,
)
from soccernerfs_tpu_torch.ops.samplers import pdf_samples, spaced_samples


@dataclass(frozen=True)
class Config:
    """Vanilla NeRF model config; field names and defaults are the JAX
    package's (its ``models/vanilla_nerf.Config``)."""

    num_coarse_samples: int = 64
    num_importance_samples: int = 128
    near_plane: float = 2.0
    far_plane: float = 6.0
    background_color: str = "white"
    eval_num_rays_per_chunk: int = 4096

    def field_config(self) -> NeRFFieldConfig:
        return NeRFFieldConfig()


def init(cfg: Config, num_train_data: int = 0,
         generator: Optional[torch.Generator] = None, device=None) -> dict:
    """Param dict {"fields": {"coarse", "fine"}} in the JAX package's
    layout."""
    fcfg = cfg.field_config()
    return {"fields": {
        "coarse": init_nerf_field(fcfg, generator, device),
        "fine": init_nerf_field(fcfg, generator, device),
    }}


def with_planes(cfg, ray_bundle: RayBundle) -> RayBundle:
    """The rays with the config's constant near and far planes, unless they
    bring their own."""
    if ray_bundle.nears is not None:
        return ray_bundle
    n, dev = ray_bundle.num_rays, ray_bundle.origins.device
    return ray_bundle.replace(
        nears=torch.full((n,), cfg.near_plane, device=dev),
        fars=torch.full((n,), cfg.far_plane, device=dev))


def proposal_anneal(cfg, step: int) -> float:
    """No proposal sampler: the protocol's anneal is 1."""
    return 1.0


def host_static_kwargs(cfg, step: int, host_state: dict) -> dict:
    """No proposal sampler: never a proposal update; ``host_state`` stays."""
    return {"train_proposal_networks": False}


def sample_counts(cfg) -> list:
    """Samples per ray of the two stratified draws: the coarse sampler's,
    then the PDF sampler's."""
    return [cfg.num_coarse_samples, cfg.num_importance_samples]


def train_draws(cfg, num_rays: int, generator: torch.Generator,
                device) -> dict:
    """The uniform draws of one training forward: per sampler the
    stratified jitter [N, S + 1]; no background draw."""
    return {"jitters": [torch.rand((num_rays, s + 1), generator=generator,
                                   device=device)
                        for s in sample_counts(cfg)],
            "background": None}


def coarse_and_fine(cfg, ray_bundle: RayBundle, field_fn, train: bool,
                    jitters: Optional[Sequence[torch.Tensor]]):
    """The two passes: uniform coarse samples, then PDF samples with the
    coarse bins merged in, each through ``field_fn(samples, level)`` ->
    (density [N, S], rgb [N, S, 3]).  Returns per level (samples, weights,
    rgb)."""
    if train and jitters is None:
        raise ValueError("training needs the jitter draws (train_draws)")
    jitters = jitters if train else (None, None)
    ray_bundle = with_planes(cfg, ray_bundle)
    coarse = spaced_samples(ray_bundle, cfg.num_coarse_samples, "uniform",
                            jitter=jitters[0])
    density_c, rgb_c = field_fn(coarse, "coarse")
    weights_c = coarse.get_weights(density_c)
    fine = pdf_samples(ray_bundle, coarse, weights_c,
                       cfg.num_importance_samples, jitter=jitters[1],
                       include_original=True)
    density_f, rgb_f = field_fn(fine, "fine")
    return (coarse, weights_c, rgb_c), (fine, fine.get_weights(density_f), rgb_f)


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
    """Forward: rgb_coarse / rgb_fine [N, 3] (rgb is the fine one), the
    accumulation and depth of both passes.  ``aabb``, ``anneal``,
    ``train_proposal_networks`` and ``background`` are not read."""
    del aabb, anneal, train_proposal_networks, background
    fcfg = cfg.field_config()

    def field_fn(samples: RaySamples, level: str):
        positions = samples.get_positions()
        n, s = positions.shape[:2]
        dirs = samples.directions[:, None, :].expand(n, s, 3)
        density, rgb = nerf_field_forward(
            fcfg, params["fields"][level], positions.reshape(-1, 3),
            dirs.reshape(-1, 3))
        return density.reshape(n, s), rgb.reshape(n, s, 3)

    (coarse, weights_c, rgb_c), (fine, weights_f, rgb_f) = coarse_and_fine(
        cfg, ray_bundle, field_fn, train, jitters)
    bg = cfg.background_color
    outputs = {
        "rgb_coarse": render_rgb(rgb_c, weights_c, bg, train),
        "rgb_fine": render_rgb(rgb_f, weights_f, bg, train),
        "accumulation_coarse": render_accumulation(weights_c),
        "accumulation": render_accumulation(weights_f),
        "depth_coarse": render_depth(weights_c, coarse),
        "depth": render_depth(weights_f, fine),
    }
    outputs["rgb"] = outputs["rgb_fine"]
    return outputs


def get_metrics_dict(cfg, outputs: dict, batch: dict, step: int = 0) -> dict:
    """PSNR of the fine render (outside the autograd graph)."""
    mse = torch.mean((outputs["rgb_fine"].detach() - batch["image"]) ** 2)
    return {"psnr": -10.0 * torch.log10(mse)}


def get_loss_dict(cfg, params: dict, outputs: dict, batch: dict,
                  metrics_dict: Optional[dict] = None
                  ) -> Dict[str, torch.Tensor]:
    """The MSE of the coarse and of the fine render."""
    image = batch["image"]
    return {"rgb_loss_coarse": L.mse_loss(image, outputs["rgb_coarse"]),
            "rgb_loss_fine": L.mse_loss(image, outputs["rgb_fine"])}
