"""Training losses (counterpart of soccernerfs_tpu/ops/losses.py).

Planes are [H, W, F] as everywhere in the port.  The plane regularizers
take their differences in bf16 and their squares and means in f32, as the
JAX versions do; autograd then carries the same bf16 rounding into their
gradients.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from soccernerfs_tpu_torch.core.rays import RaySamples

EPS = 1.0e-7
URF_SIGMA_SCALE_FACTOR = 3.0
# sqrt(2 pi) as f32 arithmetic gives it (the JAX version's jnp.sqrt)
_SQRT_2PI = float(np.sqrt(np.float32(2.0 * math.pi)))


# ---------------------------------------------------------------------------
# Interlevel (proposal distillation) loss
# ---------------------------------------------------------------------------

def outer(t0_starts, t0_ends, t1_starts, t1_ends, y1):
    """Sum of histogram (t1, y1) mass inside each (t0) interval.

    The JAX version takes masked max reductions over [..., S0, S]
    comparison tensors (4096 x 64 x 256 elements each at training width,
    which eager PyTorch would materialise); with the bins sorted and the
    cumulative sum nondecreasing they equal a searchsorted count and a
    gather, edge values included:
    ``cy1_lo = cy1[max(count(t1_starts <= t0_start) - 1, 0)]`` and
    ``cy1_hi = cy1[max(count(t1_ends <= t0_end), 1)]``.  All inputs
    [..., S]; returns [..., S0].
    """
    cy1 = torch.cat([torch.zeros_like(y1[..., :1]), torch.cumsum(y1, dim=-1)],
                    dim=-1)
    cnt_lo = torch.searchsorted(t1_starts.contiguous(), t0_starts.contiguous(),
                                right=True)
    cnt_hi = torch.searchsorted(t1_ends.contiguous(), t0_ends.contiguous(),
                                right=True)
    cy1_lo = torch.gather(cy1, -1, torch.clamp(cnt_lo - 1, min=0))
    cy1_hi = torch.gather(cy1, -1, torch.clamp(cnt_hi, min=1))
    return cy1_hi - cy1_lo


def lossfun_outer(t, w, t_env, w_env):
    """Proposal histogram bound violation."""
    w_outer = outer(t[..., :-1], t[..., 1:], t_env[..., :-1], t_env[..., 1:],
                    w_env)
    return torch.clamp(w - w_outer, min=0) ** 2 / (w + EPS)


def ray_samples_to_sdist(ray_samples: RaySamples) -> torch.Tensor:
    """s-space bin edges, [N, S+1]."""
    return torch.cat(
        [ray_samples.spacing_starts, ray_samples.spacing_ends[..., -1:]], dim=-1)


def interlevel_loss(weights_list, ray_samples_list) -> torch.Tensor:
    """MipNeRF-360 proposal loss; the final level is detached, so only the
    proposal networks are driven."""
    c = ray_samples_to_sdist(ray_samples_list[-1]).detach()
    w = weights_list[-1].detach()
    loss = 0.0
    for ray_samples, weights in zip(ray_samples_list[:-1], weights_list[:-1]):
        sdist = ray_samples_to_sdist(ray_samples)
        loss = loss + torch.mean(lossfun_outer(c, w, sdist, weights))
    return loss


# ---------------------------------------------------------------------------
# Distortion loss
# ---------------------------------------------------------------------------

def lossfun_distortion(t, w):
    """MipNeRF-360 distortion on one histogram."""
    ut = (t[..., 1:] + t[..., :-1]) / 2.0
    dut = torch.abs(ut[..., :, None] - ut[..., None, :])
    loss_inter = torch.sum(w * torch.sum(w[..., None, :] * dut, dim=-1), dim=-1)
    loss_intra = torch.sum(w ** 2 * (t[..., 1:] - t[..., :-1]), dim=-1) / 3.0
    return loss_inter + loss_intra


def distortion_loss(weights_list, ray_samples_list) -> torch.Tensor:
    """Distortion on the final (field) level."""
    c = ray_samples_to_sdist(ray_samples_list[-1])
    return torch.mean(lossfun_distortion(c, weights_list[-1]))


# ---------------------------------------------------------------------------
# K-Planes plane regularizers.  A "grids" entry is one scale's planes in the
# order (XY, XZ, XT, YZ, YT, ZT) for 4D or (XY, XZ, YZ) for 3D.
# ---------------------------------------------------------------------------

def compute_plane_tv(t: torch.Tensor, only_w: bool = False) -> torch.Tensor:
    """Mean squared difference over plane rows and columns; bf16
    differences, f32 squares and means."""
    t = t.to(torch.bfloat16)
    h_tv = torch.mean(torch.square((t[1:] - t[:-1]).float()))
    w_tv = torch.mean(torch.square((t[:, 1:] - t[:, :-1]).float()))
    return w_tv if only_w else h_tv + w_tv


def compute_plane_smoothness(t: torch.Tensor) -> torch.Tensor:
    """Mean squared second difference along the H axis (time, for the time
    planes); bf16 differences, f32 squares and means."""
    t = t.to(torch.bfloat16)
    first = t[1:] - t[:-1]
    second = (first[1:] - first[:-1]).float()
    return torch.mean(torch.square(second))


def _spatial_and_time_ids(num_planes: int):
    if num_planes == 3:
        return [0, 1, 2], []
    return [0, 1, 3], [2, 4, 5]


def space_tv_loss(multi_res_grids: Sequence[Sequence[torch.Tensor]]):
    """2D TV on space planes; 1D TV along the space axis (W) of the
    space-time planes ([T, space, F])."""
    total = 0.0
    for grids in multi_res_grids:
        spatial_ids, _ = _spatial_and_time_ids(len(grids))
        for grid_id, grid in enumerate(grids):
            total = total + compute_plane_tv(grid, only_w=grid_id not in spatial_ids)
    return total


def time_smoothness_loss(multi_res_grids: Sequence[Sequence[torch.Tensor]]):
    """Second-derivative penalty along the time axis of space-time planes."""
    total = 0.0
    for grids in multi_res_grids:
        _, time_ids = _spatial_and_time_ids(len(grids))
        for grid_id in time_ids:
            total = total + compute_plane_smoothness(grids[grid_id])
    return torch.as_tensor(total)


def sparse_transients_loss(multi_res_grids: Sequence[Sequence[torch.Tensor]]):
    """L1 pull of space-time planes toward 1, the multiplicative identity."""
    total = 0.0
    for grids in multi_res_grids:
        _, time_ids = _spatial_and_time_ids(len(grids))
        for grid_id in time_ids:
            total = total + torch.mean(torch.abs(1.0 - grids[grid_id]))
    return torch.as_tensor(total)


# ---------------------------------------------------------------------------
# Depth supervision.  ``sigma`` is a 0-d f32 tensor, so every product with
# it rounds as the JAX version's f32 arithmetic does.
# ---------------------------------------------------------------------------

def ds_nerf_depth_loss(weights, termination_depth, steps, lengths, sigma):
    """Depth-supervised NeRF loss: the negative log of each sample's
    weight under a Gaussian around the target depth (divisor 2 sigma, as
    the reference has it), summed along the ray; rays without a target
    (depth 0) count 0 in the mean.

    Args:
        weights, steps, lengths: [N, S]; termination_depth: [N].
    """
    depth_mask = termination_depth > 0
    loss = (-torch.log(weights + EPS)
            * torch.exp(-((steps - termination_depth[:, None]) ** 2)
                        / (2 * sigma))
            * lengths)
    return torch.mean(torch.sum(loss, dim=-1) * depth_mask)


def urban_radiance_field_depth_loss(weights, termination_depth,
                                    predicted_depth, steps, sigma):
    """Urban Radiance Fields' lidar loss: the expected depth's squared
    error, the weights against a Gaussian of sigma / 3 within sigma of the
    target, and the squared weights in front of it."""
    depth_mask = termination_depth > 0
    expected_depth_loss = (termination_depth - predicted_depth) ** 2
    urf_sigma = sigma / URF_SIGMA_SCALE_FACTOR
    td = termination_depth[:, None]
    target_pdf = (torch.exp(-0.5 * ((steps - td) / urf_sigma) ** 2)
                  / (urf_sigma * _SQRT_2PI))
    near_mask = (steps <= td + sigma) & (steps >= td - sigma)
    loss_near = torch.sum(near_mask * (weights - target_pdf) ** 2, dim=-1)
    empty_mask = steps < td - sigma
    loss_empty = torch.sum(empty_mask * weights ** 2, dim=-1)
    return torch.mean((expected_depth_loss + loss_near + loss_empty)
                      * depth_mask)


def depth_loss(weights: torch.Tensor, ray_samples: RaySamples,
               termination_depth: torch.Tensor, predicted_depth: torch.Tensor,
               sigma: torch.Tensor, directions_norm: torch.Tensor,
               is_euclidean: bool, depth_loss_type: str = "ds_nerf"
               ) -> torch.Tensor:
    """DS-NeRF ("ds_nerf") or URF ("urf") depth supervision of one level's
    weights [N, S].  A target that is not euclidean (a z-depth) is turned
    into a distance along the ray by ``directions_norm`` [N]."""
    if not is_euclidean:
        termination_depth = termination_depth * directions_norm
    steps = ray_samples.midpoints()
    if depth_loss_type == "ds_nerf":
        return ds_nerf_depth_loss(weights, termination_depth, steps,
                                  ray_samples.deltas, sigma)
    if depth_loss_type == "urf":
        return urban_radiance_field_depth_loss(
            weights, termination_depth, predicted_depth, steps, sigma)
    raise NotImplementedError(f"depth loss type {depth_loss_type}")


# ---------------------------------------------------------------------------
# Misc
# ---------------------------------------------------------------------------

def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - target) ** 2)


def orientation_loss(weights: torch.Tensor, normals: torch.Tensor,
                     viewdirs: torch.Tensor) -> torch.Tensor:
    """Ref-NeRF's orientation loss per ray: sum_s w min(0, n . -v)^2.
    [N, S], [N, S, 3], [N, 3] -> [N]."""
    n_dot_v = torch.sum(normals * -viewdirs[..., None, :], dim=-1)
    return torch.sum(weights * torch.clamp(n_dot_v, max=0.0) ** 2, dim=-1)


def pred_normal_loss(weights: torch.Tensor, normals: torch.Tensor,
                     pred_normals: torch.Tensor) -> torch.Tensor:
    """The predicted normals' agreement with the density's per ray:
    sum_s w (1 - n . n_pred).  [N, S], [N, S, 3], [N, S, 3] -> [N]."""
    return torch.sum(weights * (1.0 - torch.sum(normals * pred_normals, dim=-1)),
                     dim=-1)


def scale_dict(d: dict, coefficients: dict) -> dict:
    """Each loss times its coefficient (1 where it has none)."""
    return {k: d[k] * coefficients.get(k, 1.0) for k in d}
