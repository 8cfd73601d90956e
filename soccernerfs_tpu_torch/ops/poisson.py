"""Poisson surface reconstruction on a regular grid, on the host in numpy
(counterpart of soccernerfs_tpu/ops/poisson.py, whose numpy it copies).

The indicator function chi of the solid comes from an oriented point
cloud through the regularised Poisson equation

    (lap - eps) chi = div V

with V the normals splatted trilinearly onto a regular grid; the periodic
Laplacian diagonalises under the FFT, so the solve is two FFTs and a
pointwise divide.  The isosurface level is the mean of chi at the input
points, extracted by ``ops/marching.marching_tetrahedra``.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from soccernerfs_tpu_torch.ops.marching import marching_tetrahedra


def splat_vector_field(
    points: np.ndarray, vectors: np.ndarray, resolution: int
) -> np.ndarray:
    """Trilinearly splat per-point vectors onto a [R, R, R, 3] grid.

    ``points`` must already be in grid coordinates ([0, R-1] per axis;
    out-of-range points are clipped).
    """
    grid = np.zeros((resolution,) * 3 + (3,), np.float32)
    p = np.clip(points, 0.0, resolution - 1 - 1e-4)
    i0 = p.astype(np.int64)  # [N, 3]
    f = (p - i0).astype(np.float32)  # [N, 3]
    for corner in range(8):
        off = np.array([(corner >> d) & 1 for d in range(3)])
        w = np.prod(np.where(off, f, 1.0 - f), axis=-1)  # [N]
        idx = i0 + off
        np.add.at(grid, (idx[:, 0], idx[:, 1], idx[:, 2]), w[:, None] * vectors)
    return grid


def sample_trilinear(vol: np.ndarray, points: np.ndarray) -> np.ndarray:
    """Trilinear sample of a [R, R, R] volume at grid-coordinate points."""
    r = vol.shape[0]
    p = np.clip(points, 0.0, r - 1 - 1e-4)
    i0 = p.astype(np.int64)
    f = p - i0
    out = np.zeros(points.shape[0], vol.dtype)
    for corner in range(8):
        off = np.array([(corner >> d) & 1 for d in range(3)])
        w = np.prod(np.where(off, f, 1.0 - f), axis=-1)
        idx = i0 + off
        out = out + w * vol[idx[:, 0], idx[:, 1], idx[:, 2]]
    return out


def solve_poisson_fft(rhs: np.ndarray, eps: float = 1e-4) -> np.ndarray:
    """Solve (lap - eps) chi = rhs with periodic BCs on the unit-spaced
    grid.  ``eps`` removes the Laplacian's constant null-space (and acts
    as the screening data term's Tikhonov stand-in)."""
    r = rhs.shape[0]
    k = np.fft.fftfreq(r)  # cycles per sample
    # eigenvalues of the 7-point periodic Laplacian: 2(cos(2 pi k) - 1)
    lam1 = 2.0 * (np.cos(2.0 * np.pi * k) - 1.0)
    lam = (
        lam1[:, None, None] + lam1[None, :, None] + lam1[None, None, :]
    ) - eps
    chi_hat = np.fft.fftn(rhs) / lam
    return np.real(np.fft.ifftn(chi_hat)).astype(np.float32)


def poisson_reconstruct(
    points: np.ndarray,
    normals: np.ndarray,
    aabb: np.ndarray,
    resolution: int = 128,
    eps: float = 1e-4,
    pad: float = 0.1,
) -> Tuple[np.ndarray, np.ndarray]:
    """Oriented point cloud -> watertight mesh.

    Args:
        points: [N, 3] world positions.
        normals: [N, 3] outward surface normals (need not be unit).
        aabb: [2, 3] bounding box of the cloud; padded by ``pad`` of its
            extent on each side so the periodic solve doesn't wrap the
            surface onto itself.
        resolution: grid edge size R (solve is O(R^3 log R)).
    Returns:
        (vertices [V, 3] world space, faces [F, 3]).
    """
    points = np.asarray(points, np.float32)
    normals = np.asarray(normals, np.float32)
    n = np.linalg.norm(normals, axis=-1, keepdims=True)
    normals = normals / np.maximum(n, 1e-12)

    lo = np.asarray(aabb[0], np.float32)
    hi = np.asarray(aabb[1], np.float32)
    extent = hi - lo
    lo = lo - pad * extent
    hi = hi + pad * extent
    spacing = (hi - lo) / (resolution - 1)

    grid_pts = (points - lo) / spacing  # grid coords
    # V: unit-normal field on the grid (trilinear splat)
    V = splat_vector_field(grid_pts, normals, resolution)

    # div V by central differences (unit grid spacing; the constant
    # 1/(2h) scale only rescales chi, not its level set ordering)
    div = np.zeros(V.shape[:3], np.float32)
    for d in range(3):
        div += 0.5 * (
            np.roll(V[..., d], -1, axis=d) - np.roll(V[..., d], 1, axis=d)
        )

    chi = solve_poisson_fft(div, eps=eps)

    # iso level: mean indicator value at the input samples
    level = float(np.mean(sample_trilinear(chi, grid_pts)))
    verts, faces = marching_tetrahedra(chi, level, lo, spacing)
    return verts, faces


def depth_map_normals(
    point_map: np.ndarray, toward: np.ndarray
) -> np.ndarray:
    """Per-pixel normals from a structured [H, W, 3] backprojected point
    map (cross product of image-space tangents), oriented to face
    ``toward`` (the camera origin [H, W, 3] or [3])."""
    du = np.gradient(point_map, axis=1)
    dv = np.gradient(point_map, axis=0)
    n = np.cross(dv, du)
    norm = np.linalg.norm(n, axis=-1, keepdims=True)
    n = n / np.maximum(norm, 1e-12)
    view = toward - point_map
    flip = np.sum(n * view, axis=-1, keepdims=True) < 0
    return np.where(flip, -n, n)
