"""TensoRF model (counterpart of soccernerfs_tpu/models/tensorf.py).

Factorised density and colour encodings (VM, CP or triplane;
``ops/encodings.py``) over the scene box normalised to [-1, 1]^3: density
is the ReLU of the summed density features; colour is the colour features
through a learned basis ``B``, then an MLP head over [those features, the
direction, the NeRF encodings of both] (ReLU, then a sigmoid).  200
uniform samples between the scene box's entry and exit, then 50 PDF
samples of their weights (not merged), each sampler with one jitter per
ray.

Coarse-to-fine: at the ``upsampling_iters`` steps ``host_update``
resizes the VM tables to the next resolution of a log-spaced schedule
(``init_resolution`` to ``final_resolution``) and rebuilds the optimizer
state of every param group, as the JAX package does at those steps
(``optimizer.init(params)``): Adam's count restarts at 0, and since the
count also drives each group's schedule, both groups' exponential decays
restart there too.  That is the JAX package's behaviour, kept on
purpose; the nerfstudio original resets only the encodings' optimizer.
CP and triplane tables are not upsampled (nor in the JAX package).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from soccernerfs_tpu_torch.core.math import intersect_aabb
from soccernerfs_tpu_torch.core.rays import RayBundle
from soccernerfs_tpu_torch.core.scene_box import SceneBox
from soccernerfs_tpu_torch.ops import losses as L
from soccernerfs_tpu_torch.ops.encodings import (
    init_tensor_cp,
    init_tensor_vm,
    init_triplane,
    nerf_encoding,
    tensor_cp_encoding,
    tensor_vm_encoding,
    triplane_encoding,
    upsample_tensor_vm,
)
from soccernerfs_tpu_torch.ops.mlp import init_mlp, mlp_apply
from soccernerfs_tpu_torch.ops.rendering import (
    render_accumulation,
    render_depth,
    render_rgb,
)
from soccernerfs_tpu_torch.ops.samplers import pdf_samples, spaced_samples

ENCODINGS = {
    "vm": (init_tensor_vm, tensor_vm_encoding),
    "cp": (init_tensor_cp, tensor_cp_encoding),
    "triplane": (init_triplane, triplane_encoding),
}


@dataclass(frozen=True)
class Config:
    """TensoRF model config; field names and defaults are the JAX
    package's (its ``models/tensorf.Config``)."""

    init_resolution: int = 128
    final_resolution: int = 300
    upsampling_iters: Tuple[int, ...] = (2000, 3000, 4000, 5500, 7000)
    num_samples: int = 50
    num_uniform_samples: int = 200
    num_den_components: int = 16
    num_color_components: int = 48
    appearance_dim: int = 27
    tensorf_encoding: str = "vm"  # vm | cp | triplane
    background_color: str = "white"
    eval_num_rays_per_chunk: int = 4096

    def __post_init__(self):
        object.__setattr__(self, "upsampling_iters", tuple(self.upsampling_iters))

    def upsampling_resolutions(self) -> Dict[int, int]:
        """{step: the tables' resolution from that step on}: log-spaced
        from ``init_resolution`` to ``final_resolution``."""
        steps = np.round(np.exp(np.linspace(
            np.log(self.init_resolution), np.log(self.final_resolution),
            len(self.upsampling_iters) + 1))).astype(int).tolist()[1:]
        return dict(zip(self.upsampling_iters, steps))

    def resolution_at(self, step: int) -> int:
        """The tables' resolution while training step ``step`` runs."""
        res = self.init_resolution
        if self.tensorf_encoding == "vm":
            for at, r in self.upsampling_resolutions().items():
                if at <= step:
                    res = r
        return res


def color_dim(cfg: Config) -> int:
    """Width of the colour features before the basis ``B``."""
    return (3 if cfg.tensorf_encoding == "vm" else 1) * cfg.num_color_components


def head_dims(cfg: Config) -> tuple:
    """(in, hidden, hidden layers, out) of the MLP head: its input is the
    basis' output, the direction, and their 2-frequency NeRF encodings."""
    return (cfg.appearance_dim + 3 + cfg.appearance_dim * 4 + 3 * 4, 128, 1, 3)


def init(cfg: Config, num_train_data: int = 0,
         generator: Optional[torch.Generator] = None, device=None) -> dict:
    """Param dict {"encodings": {"density", "color"}, "fields": {"B",
    "mlp_head"}} in the JAX package's layout, at ``init_resolution``."""
    make = ENCODINGS[cfg.tensorf_encoding][0]
    r = cfg.init_resolution
    bound = 1.0 / math.sqrt(color_dim(cfg))
    basis = (torch.rand((color_dim(cfg), cfg.appearance_dim),
                        generator=generator) * 2 - 1) * bound
    return {
        "encodings": {
            "density": make(r, cfg.num_den_components, generator=generator,
                            device=device),
            "color": make(r, cfg.num_color_components, generator=generator,
                          device=device),
        },
        "fields": {"B": basis.to(device),
                   "mlp_head": init_mlp(*head_dims(cfg), generator=generator,
                                        device=device)},
    }


def host_update(cfg: Config, state, step: int,
                init_opt_state: Callable[[dict], dict]):
    """The coarse-to-fine upsampling before training step ``step``: at an
    upsampling step of a VM model, a copy of ``state`` whose VM tables are
    resized to the step's resolution (new leaves that require grad) and
    whose optimizer state is ``init_opt_state(params)`` for every group
    (counts, moments and schedules restart); else None."""
    schedule = cfg.upsampling_resolutions()
    if step not in schedule or cfg.tensorf_encoding != "vm":
        return None
    encodings = {}
    with torch.no_grad():
        for name, grids in state.params["encodings"].items():
            new = upsample_tensor_vm(grids, schedule[step])
            # the leaves in the order of the old ones (the gradients' order)
            encodings[name] = {k: new[k].detach().requires_grad_(True)
                               for k in grids}
    params = {**state.params, "encodings": encodings}
    return dataclasses.replace(state, params=params,
                               opt_state=init_opt_state(params))


def proposal_anneal(cfg, step: int) -> float:
    """No proposal sampler: the protocol's anneal is 1."""
    return 1.0


def host_static_kwargs(cfg, step: int, host_state: dict) -> dict:
    """No proposal sampler: never a proposal update; ``host_state`` stays."""
    return {"train_proposal_networks": False}


def sample_counts(cfg: Config) -> list:
    """Samples per ray of the uniform sampler and of the PDF sampler."""
    return [cfg.num_uniform_samples, cfg.num_samples]


def train_draws(cfg: Config, num_rays: int, generator: torch.Generator,
                device) -> dict:
    """The uniform draws of one training forward: per sampler one jitter
    per ray, [N, 1]; no background draw."""
    return {"jitters": [torch.rand((num_rays, 1), generator=generator,
                                   device=device)
                        for _ in sample_counts(cfg)],
            "background": None}


def _features(cfg: Config, grids: dict, aabb: torch.Tensor,
              positions: torch.Tensor) -> torch.Tensor:
    pts = SceneBox.get_normalized_positions(positions, aabb) * 2.0 - 1.0
    return ENCODINGS[cfg.tensorf_encoding][1](grids, pts)


def density(cfg: Config, params: dict, aabb: torch.Tensor,
            positions: torch.Tensor) -> torch.Tensor:
    """[M] densities at positions [M, 3]."""
    feats = _features(cfg, params["encodings"]["density"], aabb, positions)
    return torch.relu(torch.sum(feats, dim=-1))


def rgb(cfg: Config, params: dict, aabb: torch.Tensor, positions: torch.Tensor,
        directions: torch.Tensor) -> torch.Tensor:
    """[M, 3] colours at positions [M, 3] seen along directions [M, 3]."""
    feats = _features(cfg, params["encodings"]["color"], aabb, positions)
    rgb_features = feats @ params["fields"]["B"]
    h = torch.cat([rgb_features, directions,
                   nerf_encoding(rgb_features, 2, 0.0, 2.0),
                   nerf_encoding(directions, 2, 0.0, 2.0)], dim=-1)
    out = mlp_apply(params["fields"]["mlp_head"], h, activation="relu",
                    output_activation="relu")
    return torch.sigmoid(out)


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
    """Forward: rgb [N, 3], accumulation [N], depth [N].  The rays run
    between their entry into and exit from the scene box unless they bring
    nears and fars; in training the two samplers' jitters (``train_draws``)
    are needed.  ``anneal``, ``train_proposal_networks`` and
    ``background`` are not read."""
    del anneal, train_proposal_networks, background
    if train and jitters is None:
        raise ValueError("training needs the jitter draws (train_draws)")
    jitters = jitters if train else (None, None)
    if ray_bundle.nears is None:
        nears, fars = intersect_aabb(ray_bundle.origins, ray_bundle.directions,
                                     aabb)
        ray_bundle = ray_bundle.replace(nears=nears, fars=fars)

    coarse = spaced_samples(ray_bundle, cfg.num_uniform_samples, "uniform",
                            jitter=jitters[0])
    pos_c = coarse.get_positions()
    dens_c = density(cfg, params, aabb, pos_c.reshape(-1, 3)).reshape(
        pos_c.shape[:2])
    weights_c = coarse.get_weights(dens_c)

    fine = pdf_samples(ray_bundle, coarse, weights_c, cfg.num_samples,
                       jitter=jitters[1], include_original=False)
    pos_f = fine.get_positions()
    n, s = pos_f.shape[:2]
    flat = pos_f.reshape(-1, 3)
    dens_f = density(cfg, params, aabb, flat).reshape(n, s)
    dirs = fine.directions[:, None, :].expand(n, s, 3).reshape(-1, 3)
    rgb_f = rgb(cfg, params, aabb, flat, dirs).reshape(n, s, 3)
    weights = fine.get_weights(dens_f)
    return {
        "rgb": render_rgb(rgb_f, weights, cfg.background_color, train),
        "accumulation": render_accumulation(weights),
        "depth": render_depth(weights, fine),
    }


def get_metrics_dict(cfg, outputs: dict, batch: dict, step: int = 0) -> dict:
    """PSNR of the batch (outside the autograd graph)."""
    mse = torch.mean((outputs["rgb"].detach() - batch["image"]) ** 2)
    return {"psnr": -10.0 * torch.log10(mse)}


def get_loss_dict(cfg, params: dict, outputs: dict, batch: dict,
                  metrics_dict: Optional[dict] = None
                  ) -> Dict[str, torch.Tensor]:
    """The MSE of the render."""
    return {"rgb_loss": L.mse_loss(batch["image"], outputs["rgb"])}
