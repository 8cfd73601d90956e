"""Math primitives (counterpart of soccernerfs_tpu/core/math.py)."""
from __future__ import annotations

import math
from typing import Optional

import torch


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    """exp; the clamped-input backward of the JAX version comes with
    training (forward only here)."""
    return torch.exp(x)


def intersect_aabb(
    origins: torch.Tensor,
    directions: torch.Tensor,
    aabb: torch.Tensor,
    near_plane: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Ray/AABB slab intersection returning per-ray (nears, fars).

    Epsilon-stabilised direction reciprocal, nears clamped to
    ``near_plane`` and ``fars >= nears + 1e-6``.

    Args:
        origins, directions: [..., 3]; aabb: [2, 3] min/max corners.
    Returns:
        (nears, fars) each shaped [...].
    """
    inv_d = 1.0 / (directions + 1e-6)
    t0 = (aabb[0] - origins) * inv_d
    t1 = (aabb[1] - origins) * inv_d
    nears = torch.amax(torch.minimum(t0, t1), dim=-1)
    fars = torch.amin(torch.maximum(t0, t1), dim=-1)
    nears = torch.clamp(nears, min=near_plane)
    fars = torch.maximum(fars, nears + 1e-6)
    return nears, fars


def scene_contraction(
    x: torch.Tensor, order: Optional[float] = math.inf
) -> torch.Tensor:
    """MipNeRF-360 contraction onto a radius-2 ball (L2, ``order=None``)
    or cube (``order=inf``): x inside the unit ball, else
    (2 - 1/|x|) x/|x|."""
    if order is None:
        mag = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    elif order == math.inf:
        mag = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    else:
        mag = torch.linalg.vector_norm(x, ord=order, dim=-1, keepdim=True)
    mag = torch.clamp(mag, min=1e-12)
    return torch.where(mag < 1.0, x, (2.0 - 1.0 / mag) * (x / mag))


def components_from_spherical_harmonics(
    levels: int, directions: torch.Tensor
) -> torch.Tensor:
    """Real spherical-harmonics basis values for unit directions.

    Args:
        levels: number of SH bands (1..4); output has ``levels**2`` values.
        directions: [..., 3] unit vectors.
    Returns:
        [..., levels**2].
    """
    if not 1 <= levels <= 4:
        raise ValueError(f"SH levels must be in [1, 4], got {levels}")
    x, y, z = directions[..., 0], directions[..., 1], directions[..., 2]
    xx, yy, zz = x * x, y * y, z * z
    comps = [torch.full_like(x, 0.28209479177387814)]
    if levels > 1:
        comps += [
            0.4886025119029199 * y,
            0.4886025119029199 * z,
            0.4886025119029199 * x,
        ]
    if levels > 2:
        comps += [
            1.0925484305920792 * x * y,
            1.0925484305920792 * y * z,
            0.9461746957575601 * zz - 0.31539156525252005,
            1.0925484305920792 * x * z,
            0.5462742152960396 * (xx - yy),
        ]
    if levels > 3:
        comps += [
            0.5900435899266435 * y * (3.0 * xx - yy),
            2.890611442640554 * x * y * z,
            0.4570457994644658 * y * (5.0 * zz - 1.0),
            0.3731763325901154 * z * (5.0 * zz - 3.0),
            0.4570457994644658 * x * (5.0 * zz - 1.0),
            1.445305721320277 * z * (xx - yy),
            0.5900435899266435 * x * (xx - 3.0 * yy),
        ]
    return torch.stack(comps, dim=-1)
