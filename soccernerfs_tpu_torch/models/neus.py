"""NeuS surface model (counterpart of soccernerfs_tpu/models/neus.py): the
SDF field (fields/sdf.py) behind NeuS's hierarchical sampler
(ops/neus_sampler.py); alphas from the learned deviation's logistic CDFs
at each section's two ends along the ray; rgb, accumulation, depth and
normals; the eikonal loss on the SDF's gradients.

The normals are the SDF's gradient at the samples.  In training they stay
in the graph: the colour head and the alphas read them, and the eikonal
loss is on them, so the step's backward is a double backward.  A render
runs under ``no_grad``; the forward computes the normals all the same
(``fields.sdf.sdf_features_and_normals`` turns grad on around them).

Randomness is explicit (``train_draws``): the sampler's five stratified
jitters, [N, 1] each, and a random background's [N, 3] where the config
asks for one.  The model has no proposal sampler: it takes the
protocol's proposal schedules (``proposal_anneal``,
``host_static_kwargs``) and ignores them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import torch

from soccernerfs_tpu_torch.core.rays import (
    RayBundle,
    get_weights_and_transmittance_from_alphas,
)
from soccernerfs_tpu_torch.fields.sdf import (
    SDFFieldConfig,
    init_sdf_field,
    inv_s,
    sdf_features_and_normals,
    sdf_rgb,
    sdf_value,
)
from soccernerfs_tpu_torch.models.instant_ngp import background_for
from soccernerfs_tpu_torch.models.vanilla_nerf import (  # noqa: F401  (protocol)
    host_static_kwargs,
    proposal_anneal,
    with_planes,
)
from soccernerfs_tpu_torch.ops import losses as L
from soccernerfs_tpu_torch.ops.neus_sampler import neus_sample
from soccernerfs_tpu_torch.ops.rendering import (
    random_background,
    render_accumulation,
    render_depth,
    render_normals,
    render_rgb,
)


@dataclass(frozen=True)
class Config:
    """NeuS model config; field names and defaults are the JAX package's
    (its ``models/neus.Config``)."""

    near_plane: float = 0.05
    far_plane: float = 1000.0
    num_samples: int = 64
    num_samples_importance: int = 64
    num_upsample_steps: int = 4
    base_variance: float = 64.0
    eikonal_loss_mult: float = 0.1
    background_color: str = "black"
    sdf_field: SDFFieldConfig = SDFFieldConfig()
    eval_num_rays_per_chunk: int = 1024


def init(cfg: Config, num_train_data: int = 0,
         generator: Optional[torch.Generator] = None, device=None) -> dict:
    """Param dict {"fields": {"sdf_mlp", "color_mlp", "deviation"}} in the
    JAX package's layout, geometrically initialised."""
    return {"fields": init_sdf_field(cfg.sdf_field, generator, device)}


def train_draws(cfg: Config, num_rays: int, generator: torch.Generator,
                device) -> dict:
    """The draws of one training forward, in this order: the sampler's
    single jitters ([N, 1], the uniform sampling's, then one per upsampling
    step), then the [N, 3] random background (None for a fixed colour)."""
    jitters = [torch.rand((num_rays, 1), generator=generator, device=device)
               for _ in range(cfg.num_upsample_steps + 1)]
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
    """Forward: rgb [N, 3], accumulation [N], depth [N], normals [N, 3]
    (unit), inv_s (0-d) and, in training, "eikonal_gradients" [N, S, 3].
    ``aabb``, ``anneal`` and ``train_proposal_networks`` are not read."""
    del aabb, anneal, train_proposal_networks
    if train and jitters is None:
        raise ValueError("training needs the jitter draws (train_draws)")
    ray_bundle = with_planes(cfg, ray_bundle)
    fcfg, fparams = cfg.sdf_field, params["fields"]
    ray_samples = neus_sample(
        ray_bundle, lambda p: sdf_value(fcfg, fparams, p),
        num_samples=cfg.num_samples,
        num_samples_importance=cfg.num_samples_importance,
        num_upsample_steps=cfg.num_upsample_steps,
        base_variance=cfg.base_variance,
        jitters=jitters if train else None)

    positions = ray_samples.get_positions()
    n, s = positions.shape[:2]
    flat_pos = positions.reshape(-1, 3)
    in_graph = torch.is_grad_enabled()
    sdf, feats, normals = sdf_features_and_normals(fcfg, fparams, flat_pos,
                                                   create_graph=in_graph)
    if not in_graph:
        sdf, feats = sdf.detach(), feats.detach()
    unit_normals = normals / (torch.linalg.norm(normals, dim=-1, keepdim=True)
                              + 1e-10)
    dirs = ray_samples.directions[:, None, :].expand(n, s, 3)
    rgb = sdf_rgb(fcfg, fparams, flat_pos, dirs.reshape(-1, 3), unit_normals,
                  feats).reshape(n, s, 3)

    # the logistic CDFs of the section's two ends; iter_cos is never
    # positive
    s_inv = inv_s(fparams)
    unit_normals = unit_normals.reshape(n, s, 3)
    cos = torch.sum(unit_normals * dirs, dim=-1)
    iter_cos = -(torch.relu(-cos * 0.5 + 0.5) * 0.5 + torch.relu(-cos) * 0.5)
    deltas = ray_samples.deltas
    sdf = sdf.reshape(n, s)
    prev_cdf = torch.sigmoid((sdf + iter_cos * deltas * 0.5) * s_inv)
    next_cdf = torch.sigmoid((sdf - iter_cos * deltas * 0.5) * s_inv)
    alphas = torch.clamp((prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5),
                         0.0, 1.0)
    weights = get_weights_and_transmittance_from_alphas(alphas,
                                                        weights_only=True)
    bg = background_for(cfg.background_color, n, ray_bundle.origins.device,
                        train, background)
    outputs = {
        "rgb": render_rgb(rgb, weights, background_color=bg, train=train),
        "accumulation": render_accumulation(weights),
        "depth": render_depth(weights, ray_samples),
        "normals": render_normals(unit_normals, weights),
        "inv_s": s_inv,
    }
    if train:
        outputs["eikonal_gradients"] = normals.reshape(n, s, 3)
    return outputs


def get_metrics_dict(cfg: Config, outputs: dict, batch: dict, step: int = 0
                     ) -> dict:
    """PSNR of the batch and the inverse deviation (outside the autograd
    graph)."""
    mse = torch.mean((outputs["rgb"].detach() - batch["image"]) ** 2)
    return {"psnr": -10.0 * torch.log10(mse),
            "inv_s": outputs["inv_s"].detach()}


def get_loss_dict(cfg: Config, params: dict, outputs: dict, batch: dict,
                  metrics_dict: Optional[dict] = None
                  ) -> Dict[str, torch.Tensor]:
    """The rgb MSE and, for a training forward, the eikonal loss:
    ``eikonal_loss_mult`` times the mean of (|grad sdf| - 1)^2."""
    loss_dict = {"rgb_loss": L.mse_loss(batch["image"], outputs["rgb"])}
    if "eikonal_gradients" in outputs:
        grad_norm = torch.linalg.norm(outputs["eikonal_gradients"], dim=-1)
        loss_dict["eikonal_loss"] = cfg.eikonal_loss_mult * torch.mean(
            (grad_norm - 1.0) ** 2)
    return loss_dict
