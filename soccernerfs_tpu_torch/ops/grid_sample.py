"""Bilinear plane sampling (counterpart of soccernerfs_tpu/ops/grid_sample.py).

Semantics match ``grid_sample(align_corners=True, padding_mode="border",
mode="bilinear")`` for 2D planes.  Planes are [H, W, F], features last;
coordinates are (x, y) in [-1, 1] with x indexing W and y indexing H; a
table row id is ``y0 * W + x0``.

The two no-grad group samplers at the bottom are the render path's seams
to the CUDA kernels (ops/kernels/plane_kernels.py).
"""
from __future__ import annotations

from typing import List, Sequence

import torch

from soccernerfs_tpu_torch.ops.kernels import plane_kernels as pk


def grid_coords(coords_1d: torch.Tensor, size: int):
    """[-1, 1] -> (cell int32, frac f32) with align_corners/border
    clamping: the continuous coordinate clamps first, so x = size - 1
    gives cell size - 1 and fraction 0."""
    v = torch.clamp((coords_1d + 1.0) * 0.5 * (size - 1), 0.0, size - 1)
    c = torch.floor(v)
    return c.to(torch.int32), v - c


def sample_plane_bilinear(plane: torch.Tensor, coords: torch.Tensor
                          ) -> torch.Tensor:
    """Bilinearly sample an [H, W, F] plane at [..., 2] (x, y) coords in
    the plane's own dtype; returns [..., F]."""
    H, W, F = plane.shape
    lead = coords.shape[:-1]
    coords = coords.reshape(-1, 2)
    x0i, tx = grid_coords(coords[:, 0], W)
    y0i, ty = grid_coords(coords[:, 1], H)
    x0 = x0i.long()
    y0 = y0i.long()
    x1 = torch.clamp(x0 + 1, max=W - 1)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    flat = plane.reshape(H * W, F)
    out = pk.lerp_corners(
        flat[y0 * W + x0], flat[y0 * W + x1], flat[y1 * W + x0],
        flat[y1 * W + x1], tx, ty,
    )
    return out.reshape(*lead, F)


def quad_pack(plane: torch.Tensor) -> torch.Tensor:
    """[H, W, F] -> [H*W, 4F], each row holding the 2x2 corner block
    (P[h,w], P[h,w+1], P[h+1,w], P[h+1,w+1]); the right and bottom edges
    replicate the border."""
    H, W, F = plane.shape
    right = torch.cat([plane[:, 1:], plane[:, -1:]], dim=1)
    down = torch.cat([plane[1:], plane[-1:]], dim=0)
    down_right = torch.cat([down[:, 1:], down[:, -1:]], dim=1)
    packed = torch.cat([plane, right, down, down_right], dim=-1)
    return packed.reshape(H * W, 4 * F)


def _bilerp_rows(p, rowid, tx, ty) -> torch.Tensor:
    """Lerp one quad-packed table (gathered as bf16) at row ids; f32 out."""
    return pk.packed_rows_plain(p.to(torch.bfloat16), rowid, tx, ty)


def sample_plane_bilinear_packed(plane: torch.Tensor, coords: torch.Tensor
                                 ) -> torch.Tensor:
    """Bilinear sample through one bf16 quad-packed gather per point; the
    same clamping as ``sample_plane_bilinear``, lerp and output in f32."""
    H, W, F = plane.shape
    lead = coords.shape[:-1]
    coords = coords.reshape(-1, 2)
    x0, tx = grid_coords(coords[:, 0], W)
    y0, ty = grid_coords(coords[:, 1], H)
    out = _bilerp_rows(quad_pack(plane), y0 * W + x0, tx, ty)
    return out.reshape(*lead, F)


@torch.no_grad()
def plane_sample_packed_group(
    packeds: Sequence[torch.Tensor], rowids, txs, ty: torch.Tensor
) -> List[torch.Tensor]:
    """No-grad sample of P same-shaped quad-packed [R, 4F] bf16 tables
    staged once per snapshot (fields/kplanes.pack_grids_for_render).

    Args:
        packeds: P [R, 4F] bf16 of planes sharing their y axis;
        rowids: P [M] int32 (any order); txs: P [M] f32; ty: [M] f32.
    Returns:
        P [M, F] f32 features.
    """
    return pk.bilerp_fwd_packed(list(packeds), list(rowids), list(txs), ty)


@torch.no_grad()
def plane_sample_unpacked_group(
    tables: Sequence[torch.Tensor], rowids, txs, ty: torch.Tensor, *,
    h: int, w: int
) -> List[torch.Tensor]:
    """No-grad sample of P big tables staged as bf16 unpacked [h*w, F]
    copies (4x less snapshot memory than quad-packed ones).

    Args:
        tables: P [h*w, F] bf16; rowids/txs/ty as plane_sample_packed_group.
    Returns:
        P [M, F] f32 features.
    """
    return pk.bilerp_fwd_unpacked(list(tables), list(rowids), list(txs), ty,
                                  h=h, w=w)
