"""Lie-group exponential maps for pose optimization (counterpart of
soccernerfs_tpu/core/lie_groups.py)."""
from __future__ import annotations

import torch


def _skew(v: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 3, 3] skew-symmetric cross-product matrices."""
    zeros = torch.zeros_like(v[..., 0])
    return torch.stack(
        [
            torch.stack([zeros, -v[..., 2], v[..., 1]], dim=-1),
            torch.stack([v[..., 2], zeros, -v[..., 0]], dim=-1),
            torch.stack([-v[..., 1], v[..., 0], zeros], dim=-1),
        ],
        dim=-2,
    )


def exp_map_SO3xR3(tangent_vector: torch.Tensor) -> torch.Tensor:
    """exp of the direct product SO(3) x R^3.

    Args:
        tangent_vector: [B, 6], translation (3) then so(3) tangent (3).
    Returns:
        [B, 3, 4] [R|t] matrices; the translation is copied verbatim.
    """
    log_rot = tangent_vector[:, 3:]
    nrms = torch.sum(log_rot * log_rot, dim=1)
    rot_angles = torch.sqrt(torch.clamp(nrms, min=1e-4))
    inv = 1.0 / rot_angles
    fac1 = inv * torch.sin(rot_angles)
    fac2 = inv * inv * (1.0 - torch.cos(rot_angles))
    skews = _skew(log_rot)
    skews_square = torch.matmul(skews, skews)
    rot = (
        fac1[:, None, None] * skews
        + fac2[:, None, None] * skews_square
        + torch.eye(3, dtype=skews.dtype, device=skews.device)[None]
    )
    return torch.cat([rot, tangent_vector[:, :3, None]], dim=-1)


def exp_map_SE3(tangent_vector: torch.Tensor) -> torch.Tensor:
    """exp se(3) -> SE(3) with small-angle Taylor guards.

    Args:
        tangent_vector: [B, 6], translation part (3) then rotation (3).
    Returns:
        [B, 3, 4] [R|t].
    """
    lin = tangent_vector[:, :3]
    ang = tangent_vector[:, 3:]
    eye = torch.eye(3, dtype=ang.dtype, device=ang.device)[None]

    theta2 = torch.sum(ang * ang, dim=1, keepdim=True)
    theta = torch.sqrt(theta2)
    near_zero = theta < 1e-2
    one = torch.ones_like(theta)
    theta_nz = torch.where(near_zero, one, theta)
    theta2_nz = torch.where(near_zero, one, theta2)
    theta3_nz = torch.where(near_zero, one, theta2 * theta)

    sine = torch.sin(theta)
    cosine = torch.where(near_zero, 8.0 / (4.0 + theta2) - 1.0, torch.cos(theta))
    sine_by_theta = torch.where(near_zero, 0.5 * cosine + 0.5, sine / theta_nz)
    one_minus_cos_by_t2 = torch.where(
        near_zero, 0.5 * sine_by_theta, (1.0 - cosine) / theta2_nz
    )

    outer = ang[:, :, None] * ang[:, None, :]
    rot = (
        one_minus_cos_by_t2[:, :, None] * outer
        + cosine[:, :, None] * eye
        + sine_by_theta[:, :, None] * _skew(ang)
    )

    # V matrix for the translation
    sine_by_theta_t = torch.where(near_zero, 1.0 - theta2 / 6.0, sine_by_theta)
    one_minus_cos_by_t2_t = torch.where(
        near_zero, 0.5 - theta2 / 24.0, one_minus_cos_by_t2
    )
    theta_minus_sine_by_t3 = torch.where(
        near_zero, 1.0 / 6.0 - theta2 / 120.0, (theta - sine) / theta3_nz
    )
    V = (
        sine_by_theta_t[:, :, None] * eye
        + one_minus_cos_by_t2_t[:, :, None] * _skew(ang)
        + theta_minus_sine_by_t3[:, :, None] * outer
    )
    trans = torch.matmul(V, lin[:, :, None])
    return torch.cat([rot, trans], dim=-1)
