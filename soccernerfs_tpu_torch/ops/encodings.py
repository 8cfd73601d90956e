"""Coordinate encodings (counterpart of soccernerfs_tpu/ops/encodings.py).

NeRF's sinusoidal encoding (with mip-NeRF's integrated variant over
sample covariances), the TensoRF factorised encodings (CP, VM,
triplane) with their inits and the VM grids' upsampling, and mip-NeRF's
conical frustum -> Gaussian.  Hash-grid encodings live in
``ops/hash_grid.py``.

The planes of the VM and triplane encodings are sampled as the JAX
package samples them, through one bf16 quad-packed gather per point
(``ops/grid_sample.sample_plane_bilinear_packed``), differentiable in
the planes; the lines are f32 gathers and lerps.  Positions carry no
gradient into the encodings' lookups (the JAX versions' positions do, but
no registered method trains the positions of these encodings).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from soccernerfs_tpu_torch.ops.grid_sample import sample_plane_bilinear_packed

# plane axes and the orthogonal line axis of each VM component
PLANE_PAIRS = ((0, 1), (0, 2), (1, 2))
LINE_AXES = (2, 1, 0)


def linspace_f32(start: float, stop: float, num: int) -> np.ndarray:
    """``jnp.linspace(start, stop, num)`` in f32 as XLA computes it on the
    CPU: ``start * (1 - s) + stop * s`` with ``s = i * (1 / (num - 1))``
    (XLA multiplies by the divisor's reciprocal), the last point ``stop``
    itself.  ``torch.linspace`` and ``np.linspace`` round some points the
    other way, and the NeRF encoding's top frequency (2^16) turns one ulp
    of its exponent into a visible change of the sinusoid."""
    f = np.float32
    if num == 1:
        return np.array([start], f)
    step = np.arange(num - 1, dtype=f) * (f(1) / f(num - 1))
    return np.append(f(start) * (f(1) - step) + f(stop) * step, f(stop))


def nerf_encoding(
    x: torch.Tensor,
    num_frequencies: int,
    min_freq_exp: float,
    max_freq_exp: float,
    include_input: bool = False,
    covs: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """NeRF's sinusoidal encoding of ``x`` scaled by 2 pi.

    Args:
        x: [..., D].
        covs: optional [..., D, D] covariances: mip-NeRF's integrated
            encoding damps each sinusoid by exp(-var / 2) of its scaled
            variance.
    Returns:
        [..., D * num_frequencies * 2 (+ D)]: the sines of every
        (component, frequency), then the cosines (sines shifted by pi/2).
    """
    freqs = torch.exp2(torch.from_numpy(
        linspace_f32(min_freq_exp, max_freq_exp, num_frequencies)).to(x.device))
    scaled = (2.0 * math.pi * x)[..., None] * freqs           # [..., D, F]
    scaled = scaled.reshape(*x.shape[:-1], -1)
    encoded = torch.sin(torch.cat([scaled, scaled + math.pi / 2.0], dim=-1))
    if covs is not None:
        var = torch.diagonal(covs, dim1=-2, dim2=-1)[..., None] * freqs**2
        var = ((2.0 * math.pi) ** 2 * var).reshape(*x.shape[:-1], -1)
        damp = torch.exp(-0.5 * var)
        encoded = encoded * torch.cat([damp, damp], dim=-1)
    if include_input:
        encoded = torch.cat([encoded, x], dim=-1)
    return encoded


def _line_coords(x: torch.Tensor, resolution: int):
    """Cells (p0, p1) and fractions of [-1, 1] coordinates on lines of
    ``resolution`` points, align_corners and border-clamped."""
    pos = torch.clamp((x + 1.0) * 0.5 * (resolution - 1), 0, resolution - 1)
    p0 = torch.floor(pos)
    t = pos - p0
    p0 = p0.long()
    return p0, torch.clamp(p0 + 1, max=resolution - 1), t


def _line_lerp(line: torch.Tensor, p0, p1, t) -> torch.Tensor:
    """Lerp of an [R, C] line at cells p0, p1 [...] with fractions t."""
    return line[p0] * (1 - t[..., None]) + line[p1] * t[..., None]


def init_tensor_cp(resolution: int, num_components: int, init_scale: float = 0.1,
                   generator: Optional[torch.Generator] = None, device=None
                   ) -> dict:
    """CP decomposition: per-axis lines [3, R, C], N(0, init_scale^2)."""
    return {"line_coef": (init_scale * torch.randn(
        (3, resolution, num_components), generator=generator)).to(device)}


def tensor_cp_encoding(params: dict, x: torch.Tensor) -> torch.Tensor:
    """x in [-1, 1]^3 -> [..., C]: the product of the three axes' line
    lerps."""
    line = params["line_coef"]
    p0, p1, t = _line_coords(x, line.shape[1])
    out = 1.0
    for axis in range(3):
        out = out * _line_lerp(line[axis], p0[..., axis], p1[..., axis],
                               t[..., axis])
    return out


def init_tensor_vm(resolution: int, num_components: int, init_scale: float = 0.1,
                   generator: Optional[torch.Generator] = None, device=None
                   ) -> dict:
    """VM decomposition: 3 planes [3, R, R, C] and 3 lines [3, R, C],
    N(0, init_scale^2)."""
    planes = init_scale * torch.randn((3, resolution, resolution, num_components),
                                      generator=generator)
    lines = init_scale * torch.randn((3, resolution, num_components),
                                     generator=generator)
    return {"plane_coef": planes.to(device), "line_coef": lines.to(device)}


def tensor_vm_encoding(params: dict, x: torch.Tensor) -> torch.Tensor:
    """x in [-1, 1]^3 -> [..., 3C]: per component i, the plane over axes
    ``PLANE_PAIRS[i]`` times the line along ``LINE_AXES[i]``."""
    planes, lines = params["plane_coef"], params["line_coef"]
    p0, p1, t = _line_coords(x, lines.shape[1])
    outs = []
    for i, (a, b) in enumerate(PLANE_PAIRS):
        plane_feat = sample_plane_bilinear_packed(
            planes[i], torch.stack([x[..., a], x[..., b]], dim=-1))
        la = LINE_AXES[i]
        outs.append(plane_feat * _line_lerp(lines[i], p0[..., la], p1[..., la],
                                            t[..., la]))
    return torch.cat(outs, dim=-1)


def upsample_tensor_vm(params: dict, new_resolution: int) -> dict:
    """The VM grids bilinearly resized to ``new_resolution``, as
    ``jax.image.resize(..., "bilinear")`` resizes them: half-pixel centres
    with the border replicated (``F.interpolate(align_corners=False)``), not
    the corner-aligned resize of the nerfstudio original.  Upsampling only:
    a smaller resolution raises (``jax.image.resize`` would antialias)."""
    planes, lines = params["plane_coef"], params["line_coef"]
    if new_resolution < lines.shape[1]:
        raise ValueError(f"upsample_tensor_vm to {new_resolution} from "
                         f"{lines.shape[1]}: upsampling only")
    new_planes = F.interpolate(
        planes.permute(0, 3, 1, 2), size=(new_resolution, new_resolution),
        mode="bilinear", align_corners=False, antialias=False,
    ).permute(0, 2, 3, 1).contiguous()
    new_lines = F.interpolate(
        lines.permute(0, 2, 1), size=new_resolution, mode="linear",
        align_corners=False,
    ).permute(0, 2, 1).contiguous()
    return {"plane_coef": new_planes, "line_coef": new_lines}


def init_triplane(resolution: int, num_components: int, init_scale: float = 0.1,
                  generator: Optional[torch.Generator] = None, device=None
                  ) -> dict:
    """Triplane: 3 planes [3, R, R, C], N(0, init_scale^2), summed."""
    return {"plane_coef": (init_scale * torch.randn(
        (3, resolution, resolution, num_components), generator=generator)
    ).to(device)}


def triplane_encoding(params: dict, x: torch.Tensor) -> torch.Tensor:
    """x in [-1, 1]^3 -> [..., C]: the sum of the three planes' samples."""
    planes = params["plane_coef"]
    out = 0.0
    for i, (a, b) in enumerate(PLANE_PAIRS):
        out = out + sample_plane_bilinear_packed(
            planes[i], torch.stack([x[..., a], x[..., b]], dim=-1))
    return out


def conical_frustum_to_gaussian(
    origins: torch.Tensor,
    directions: torch.Tensor,
    starts: torch.Tensor,
    ends: torch.Tensor,
    radius: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """mip-NeRF's Gaussian approximation of a conical frustum (eq. 7).

    Args:
        origins, directions: [..., 3] (unit directions);
        starts, ends, radius: [..., 1].
    Returns:
        (means [..., 3], covs [..., 3, 3]).
    """
    mu = (starts + ends) / 2.0
    hw = (ends - starts) / 2.0
    # integer powers as products, as XLA computes them
    mu2, hw2 = mu * mu, hw * hw
    hw4 = hw2 * hw2
    denom = 3.0 * mu2 + hw2
    t_mean = mu + (2.0 * mu * hw2) / denom
    t_var = hw2 / 3.0 - (4.0 / 15.0) * ((hw4 * (12.0 * mu2 - hw2))
                                        / (denom * denom))
    r_var = (radius * radius) * (mu2 / 4.0 + (5.0 / 12.0) * hw2
                                 - (4.0 / 15.0) * hw4 / denom)
    means = origins + directions * t_mean
    d_outer = directions[..., :, None] * directions[..., None, :]
    null_outer = torch.eye(3, device=directions.device) - d_outer
    covs = t_var[..., None] * d_outer + r_var[..., None] * null_outer
    return means, covs
