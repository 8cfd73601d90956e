"""Bilinear plane sampling (counterpart of soccernerfs_tpu/ops/grid_sample.py).

Semantics match ``grid_sample(align_corners=True, padding_mode="border",
mode="bilinear")`` for 2D planes.  Planes are [H, W, F], features last;
coordinates are (x, y) in [-1, 1] with x indexing W and y indexing H; a
table row id is ``y0 * W + x0``.

The group samplers at the bottom are the train path's seams to the CUDA
kernels (ops/kernels/plane_kernels.py): two ``torch.autograd.Function``s,
the counterparts of the JAX package's ``custom_vjp``s, whose backward runs
the backward kernels.  The render path samples the tables that
``stage_table`` stages once per snapshot through one fused launch per
scale (``plane_kernels.kplanes_fwd_fused``, called by
fields/kplanes.interpolate_kplanes).
"""
from __future__ import annotations

from typing import List, Sequence

import torch

from soccernerfs_tpu_torch.ops.kernels import plane_kernels as pk
from soccernerfs_tpu_torch.ops.kernels.plane_kernels import grid_coords


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


def stage_table(plane: torch.Tensor) -> torch.Tensor:
    """The bf16 table the forward kernels sample for an [H, W, F] plane:
    big F = 32 planes (H*W >= 65536 and W % 32 == 0) unpacked, [H*W, F]
    (4x less memory); the rest quad-packed, [H*W, 4F] (one contiguous
    row per point).  Both hold the same bf16 values; kplanes_fwd_fused
    takes either, bilerp_fwd_unpacked and bilerp_fwd_packed one each."""
    h, w, f = plane.shape
    if 4 * f == 128 and h * w >= 65536 and w % 32 == 0:
        return plane.reshape(h * w, f).to(torch.bfloat16).contiguous()
    return quad_pack(plane.to(torch.bfloat16)).contiguous()


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


def _split(n: int, tensors):
    return tensors[:n], tensors[n:2 * n], tensors[2 * n:]


class _FoldGroup(torch.autograd.Function):
    """Forward: stage the grids to bf16 (``stage_table``) and sample them
    with the forward kernel the staging picks.  Backward: the unpacked
    backward kernel for every table, [H*W, F] f32 straight into the grid's
    gradient.  Row ids and fractions get no gradient."""

    @staticmethod
    def forward(ctx, n, ty, *tensors):
        grids, rowids, txs = _split(n, tensors)
        h, w, feat = grids[0].shape
        tables = [stage_table(g) for g in grids]
        if tables[0].shape[-1] == feat:
            feats = pk.bilerp_fwd_unpacked(tables, rowids, txs, ty, h=h, w=w)
        else:
            feats = pk.bilerp_fwd_packed(tables, rowids, txs, ty)
        ctx.save_for_backward(ty, *rowids, *txs)
        ctx.shape = (n, h, w, feat)
        return tuple(feats)

    @staticmethod
    def backward(ctx, *gouts):
        n, h, w, feat = ctx.shape
        ty, *rest = ctx.saved_tensors
        rowids, txs = rest[:n], rest[n:]
        need = [i for i in range(n) if ctx.needs_input_grad[2 + i]]
        grads = pk.bilerp_bwd_unpacked(
            [gouts[i].contiguous() for i in need], [rowids[i] for i in need],
            [txs[i] for i in need], ty, h=h, w=w)
        out = [None] * n
        for i, g in zip(need, grads):
            out[i] = g.reshape(h, w, feat)
        return (None, None, *out, *([None] * (2 * n)))


class _PackedGroup(torch.autograd.Function):
    """Forward: bilerp_fwd_packed on the quad-packed tables cast to bf16.
    Backward: bilerp_bwd_packed, f32 [R, 4F] per table.  Row ids and
    fractions get no gradient."""

    @staticmethod
    def forward(ctx, n, ty, *tensors):
        tables, rowids, txs = _split(n, tensors)
        feats = pk.bilerp_fwd_packed(
            [t.to(torch.bfloat16).contiguous() for t in tables], rowids, txs,
            ty)
        ctx.save_for_backward(ty, *rowids, *txs)
        ctx.shape = (n, tables[0].shape[0])
        return tuple(feats)

    @staticmethod
    def backward(ctx, *gouts):
        n, rows = ctx.shape
        ty, *rest = ctx.saved_tensors
        rowids, txs = rest[:n], rest[n:]
        need = [i for i in range(n) if ctx.needs_input_grad[2 + i]]
        grads = pk.bilerp_bwd_packed(
            [gouts[i].contiguous() for i in need], [rowids[i] for i in need],
            [txs[i] for i in need], ty, rows=rows)
        out = [None] * n
        for i, g in zip(need, grads):
            out[i] = g
        return (None, None, *out, *([None] * (2 * n)))


def plane_sample_fold_group(grids: Sequence[torch.Tensor], rowids, txs,
                            ty: torch.Tensor) -> List[torch.Tensor]:
    """Differentiable bilinear sample of P same-shaped f32 [H, W, F] planes
    that share their y axis: the gradient boundary sits at the grids.

    Args:
        grids: P [H, W, F] f32; rowids: P [M] int32 (y0*W + x0, any
            order); txs: P [M] f32; ty: [M] f32 (no gradient flows to
            these).
    Returns:
        P [M, F] f32 features.
    """
    return list(_FoldGroup.apply(len(grids), ty, *grids, *rowids, *txs))


def plane_sample_group_bwdsort(tables: Sequence[torch.Tensor], rowids, txs,
                               ty: torch.Tensor) -> List[torch.Tensor]:
    """Differentiable bilinear sample of P same-shaped f32 quad-packed
    [R, 4F] tables (``quad_pack`` of the grids, outside this function, so
    autograd's transpose of it folds the packed gradient into the grid).
    The JAX version sorts the points inside its backward for the TPU
    kernel; the CUDA kernel takes them in any order.

    Args:
        tables: P [R, 4F] f32; rowids, txs, ty: as plane_sample_fold_group.
    Returns:
        P [M, F] f32 features.
    """
    return list(_PackedGroup.apply(len(tables), ty, *tables, *rowids, *txs))
