"""Instant-NGP model (counterpart of soccernerfs_tpu/models/instant_ngp.py):
occupancy-grid volumetric sampling with static shapes
(``ops/occupancy.py``), the instant-NGP field, the alive-ray-masked rgb
loss, and the grid's EMA update every ``update_every`` steps after the
optimizer step (``update_aux``).  ``instant-ngp-bounded`` is this model
with the scene box's normalisation in place of the contraction.

The model's non-trainable state is ``aux = {"occs": [R^3]}``:
``schedules`` gives a train forward the binarized grid as it stood before
the step, ``eval_kwargs`` a render's, and ``update_aux`` the next grid.
The host decides whether a step updates (``step % update_every == 0``)
and which update runs (all cells before ``warmup_steps``, sampled after).

Randomness is explicit (``train_draws``, ``aux_draws``): the probes'
stratified jitter [N, 1], the random background [N, 3], and the update's
cell jitter, uniform cells and occupied-cell uniforms.  The model has no
proposal sampler: it takes the protocol's proposal schedules
(``proposal_anneal``, ``host_static_kwargs``) and ignores them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import torch

from soccernerfs_tpu_torch.core.math import intersect_aabb
from soccernerfs_tpu_torch.core.rays import RayBundle
from soccernerfs_tpu_torch.fields.instant_ngp import (
    InstantNGPFieldConfig,
    init_instant_ngp_field,
    instant_ngp_density,
    instant_ngp_rgb,
)
from soccernerfs_tpu_torch.ops.occupancy import (
    OccupancyGridConfig,
    init_occupancy_grid,
    occupancy_binary,
    update_draws,
    update_occupancy_grid,
    volumetric_sample,
)
from soccernerfs_tpu_torch.ops.rendering import (
    random_background,
    render_accumulation,
    render_depth,
    render_rgb,
)


@dataclass(frozen=True)
class Config:
    """Instant-NGP model config; field names and defaults are the JAX
    package's (its ``models/instant_ngp.Config``)."""

    enable_collider: bool = False
    max_num_samples_per_ray: int = 24
    num_probes_per_ray: int = 256
    grid_resolution: int = 128
    max_res: int = 2048
    log2_hashmap_size: int = 19
    contraction_type: str = "un_bounded_sphere"
    cone_angle: float = 0.004
    render_step_size: float = 0.01
    near_plane: float = 0.05
    far_plane: float = 1e3
    use_appearance_embedding: bool = False
    background_color: str = "random"
    eval_num_rays_per_chunk: int = 8192

    def field_config(self, num_images: int = 0) -> InstantNGPFieldConfig:
        return InstantNGPFieldConfig(
            max_res=self.max_res,
            log2_hashmap_size=self.log2_hashmap_size,
            use_appearance_embedding=self.use_appearance_embedding,
            contraction_type=self.contraction_type,
            num_images=num_images,
        )

    @property
    def occ(self) -> OccupancyGridConfig:
        return OccupancyGridConfig(resolution=self.grid_resolution)


def init(cfg: Config, num_train_data: int = 0,
         generator: Optional[torch.Generator] = None, device=None) -> dict:
    """Param dict {"fields": ...} in the JAX package's layout."""
    return {"fields": init_instant_ngp_field(cfg.field_config(num_train_data),
                                             generator=generator, device=device)}


def init_aux(cfg, device=None) -> dict:
    """The non-trainable state: the occupancy grid, zeros."""
    return {"occs": init_occupancy_grid(cfg.occ, device)}


def eval_kwargs(cfg, aux: dict) -> dict:
    """A render's extra kwargs: the binarized grid of ``aux``."""
    return {"occ_binary": occupancy_binary(cfg.occ, aux["occs"])}


def schedules(cfg, step: int, aux: dict) -> dict:
    """The train forward's extra kwargs at ``step``: the binarized grid of
    ``aux`` (the state before the step), as a render's."""
    return eval_kwargs(cfg, aux)


def update_due(cfg, step: int) -> bool:
    """Whether the step updates the grid (the host's decision)."""
    return step % cfg.occ.update_every == 0


def aux_draws(cfg, step: int, generator: Optional[torch.Generator],
              device) -> dict:
    """The draws of the grid update at ``step`` (``update_draws``)."""
    return update_draws(cfg.occ, step, generator, device)


def update_aux(cfg, params: dict, aabb: torch.Tensor, step: int, aux: dict,
               generator: Optional[torch.Generator] = None,
               draws: Optional[dict] = None) -> dict:
    """The state after the optimizer step at ``step`` (``params`` are the
    updated ones): on an update step the grid's EMA update with
    ``draws`` (``aux_draws``' layout; drawn from ``generator`` when None),
    else ``aux`` itself."""
    if not update_due(cfg, step):
        return aux
    if draws is None:
        draws = aux_draws(cfg, step, generator, aux["occs"].device)
    fcfg = cfg.field_config()

    def density_fn(positions):
        return instant_ngp_density(fcfg, params["fields"], aabb, positions)[0]

    occs = update_occupancy_grid(cfg.occ, aux["occs"], aabb, density_fn,
                                 cfg.render_step_size, step=step, draws=draws)
    return {**aux, "occs": occs}


def proposal_anneal(cfg, step: int) -> float:
    """No proposal sampler: the protocol's anneal is 1."""
    return 1.0


def host_static_kwargs(cfg, step: int, host_state: dict) -> dict:
    """No proposal sampler: never a proposal update; ``host_state`` stays."""
    return {"train_proposal_networks": False}


def train_draws(cfg: Config, num_rays: int, generator: torch.Generator,
                device) -> dict:
    """The draws of one training forward, in this order: the probes'
    stratified jitter ([N, 1], in a list of one), then the [N, 3] random
    background (None for a fixed colour)."""
    jitter = torch.rand((num_rays, 1), generator=generator, device=device)
    background = (random_background(num_rays, device, generator)
                  if cfg.background_color == "random" else None)
    return {"jitters": [jitter], "background": background}


def collider(cfg, ray_bundle: RayBundle, aabb: torch.Tensor) -> RayBundle:
    """Nears and fars from the scene box (nears at least ``near_plane``,
    fars at most ``far_plane``), unless the rays bring theirs."""
    if ray_bundle.nears is not None and ray_bundle.fars is not None:
        return ray_bundle
    nears, fars = intersect_aabb(ray_bundle.origins, ray_bundle.directions,
                                 aabb, near_plane=cfg.near_plane)
    return ray_bundle.replace(nears=nears,
                              fars=torch.clamp(fars, max=cfg.far_plane))


def occupancy_samples(cfg, ray_bundle: RayBundle, aabb: torch.Tensor,
                      occ_binary: Optional[torch.Tensor],
                      jitters: Optional[Sequence[torch.Tensor]], train: bool):
    """(rays with nears and fars, RaySamples [N, S], valid [N, S]): the
    collider, then ``volumetric_sample`` over ``occ_binary`` (all cells
    occupied when None), jittered by ``jitters[0]`` in training, which
    needs it."""
    if train and jitters is None:
        raise ValueError("training needs the jitters and background draws "
                         "(train_draws)")
    ray_bundle = collider(cfg, ray_bundle, aabb)
    if occ_binary is None:
        occ_binary = torch.ones((cfg.occ.n_cells,), dtype=torch.bool,
                                device=ray_bundle.origins.device)
    ray_samples, valid = volumetric_sample(
        cfg.occ, occ_binary, ray_bundle, aabb,
        num_probes=cfg.num_probes_per_ray,
        max_samples_per_ray=cfg.max_num_samples_per_ray,
        jitter=jitters[0] if train else None)
    return ray_bundle, ray_samples, valid


def background_for(color: str, n: int, dev, train: bool,
                   background: Optional[torch.Tensor]):
    """The compositing background: ``background`` for "random" (training
    needs it; outside training ``random_background``'s fixed-seed draw
    when None), else the colour's name."""
    if color != "random":
        return color
    if background is None:
        if train:
            raise ValueError("training needs the jitters and background "
                             "draws (train_draws)")
        background = random_background(n, dev)
    return background


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
    occ_binary: Optional[torch.Tensor] = None,
) -> dict:
    """Forward: rgb [N, 3], accumulation [N], depth [N], alive_ray_mask
    [N], num_samples_per_ray [N], the weights, samples and valid mask, and
    directions_norm [N].

    Samples come from ``occ_binary`` (``schedules`` / ``eval_kwargs``; all
    cells when None), with the stratified jitter ``jitters[0]`` in
    training; invalid samples get density 0.  ``anneal`` and
    ``train_proposal_networks`` are ignored (no proposal sampler).
    """
    del anneal, train_proposal_networks
    ray_bundle, ray_samples, valid = occupancy_samples(
        cfg, ray_bundle, aabb, occ_binary, jitters, train)
    n, s = valid.shape
    fcfg = cfg.field_config()
    positions = ray_samples.get_positions()
    density, geo = instant_ngp_density(fcfg, params["fields"], aabb,
                                       positions.reshape(-1, 3))
    flat_dirs = ray_samples.directions[:, None, :].expand(n, s, 3).reshape(-1, 3)
    flat_cam = (torch.repeat_interleave(ray_samples.camera_indices, s)
                if ray_samples.camera_indices is not None else None)
    rgb_samples = instant_ngp_rgb(fcfg, params["fields"], geo, flat_dirs,
                                  flat_cam, train).reshape(n, s, 3)
    # invalid samples contribute nothing, also where their density
    # overflowed to inf (a product with the mask would make that NaN)
    weights = ray_samples.get_weights(
        torch.where(valid, density.reshape(n, s), 0.0))
    bg = background_for(cfg.background_color, n, ray_bundle.origins.device,
                        train, background)
    outputs = {
        "rgb": render_rgb(rgb_samples, weights, background_color=bg, train=train),
        "accumulation": render_accumulation(weights),
        "depth": render_depth(weights, ray_samples),
        "alive_ray_mask": torch.any(valid, dim=-1),
        "num_samples_per_ray": torch.sum(valid, dim=-1),
        "weights": weights,
        "ray_samples": ray_samples,
        "valid": valid,
    }
    if ray_bundle.directions_norm is not None:
        outputs["directions_norm"] = ray_bundle.directions_norm
    return outputs


def get_metrics_dict(cfg, outputs: dict, batch: dict, step: int = 0) -> dict:
    """PSNR of the batch and the samples it took (outside the autograd
    graph)."""
    mse = torch.mean((outputs["rgb"].detach() - batch["image"]) ** 2)
    return {"psnr": -10.0 * torch.log10(mse),
            "num_samples_per_batch": torch.sum(outputs["num_samples_per_ray"])}


def masked_rgb_loss(outputs: dict, batch: dict) -> torch.Tensor:
    """MSE over the rays with at least one valid sample."""
    mask = outputs["alive_ray_mask"][:, None]
    denom = torch.clamp(mask.sum() * 3, min=1).float()
    return torch.sum(torch.where(mask, (batch["image"] - outputs["rgb"]) ** 2,
                                 0.0)) / denom


def get_loss_dict(cfg: Config, params: dict, outputs: dict, batch: dict,
                  metrics_dict: Optional[dict] = None) -> Dict[str, torch.Tensor]:
    """The training loss dict: the alive-ray-masked rgb loss."""
    return {"rgb_loss": masked_rgb_loss(outputs, batch)}
