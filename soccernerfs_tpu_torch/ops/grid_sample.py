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


def stage_table(plane: torch.Tensor, packed: bool = False) -> torch.Tensor:
    """The bf16 table the forward kernels sample for an [H, W, F] plane:
    [H*W, F] (the plane itself), or with ``packed`` quad-packed [H*W, 4F]
    (one contiguous row per point, 4x the bytes).  Both hold the same bf16
    values; kplanes_fwd_fused takes either, bilerp_fwd_unpacked and
    bilerp_fwd_packed one each.  A width the kernels have no instance of
    is zero-padded to the next one (``plane_kernels.native_feat``): F = 20
    stages [H*W, 24] or [H*W, 4 * 24], the last 4 features of each
    quarter 0."""
    h, w, f = plane.shape
    if pk.native_feat(f) != f:
        plane = torch.nn.functional.pad(plane, (0, pk.native_feat(f) - f))
        f = plane.shape[-1]
    if packed:
        return quad_pack(plane.to(torch.bfloat16)).contiguous()
    return plane.reshape(h * w, f).to(torch.bfloat16).contiguous()


def render_packs(h: int, w: int, feat: int) -> bool:
    """Whether the render path (fields/kplanes.pack_grids_for_render, one
    staging a snapshot) quad-packs an [h, w, feat] plane's table."""
    return not (4 * feat == 128 and h * w >= 65536 and w % 32 == 0)


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


def _coord_grads(ctx, tables, gouts, rowids, txs, ty, h, w):
    """The fractions' gradients of a group's backward, when autograd asks
    for any (``ctx.needs_input_grad``): one ``bilerp_bwd_coords`` launch
    over the forward's staged tables.  Returns (P gradients of the txs,
    the gradient of ty), None where not needed."""
    n = len(rowids)
    need_ty = ctx.needs_input_grad[1]
    need_tx = [ctx.needs_input_grad[2 + 2 * n + i] for i in range(n)]
    if not (need_ty or any(need_tx)):
        return [None] * n, None
    d_txs, d_ty = pk.bilerp_bwd_coords(
        tables, [g.contiguous() for g in gouts], rowids, txs, ty, h=h, w=w)
    return ([d if need else None for d, need in zip(d_txs, need_tx)],
            d_ty if need_ty else None)


def _needs_coord_grads(ctx, n) -> bool:
    return ctx.needs_input_grad[1] or any(ctx.needs_input_grad[2 + 2 * n:])


class _FoldGroup(torch.autograd.Function):
    """Forward: stage the grids to bf16 [H*W, F] tables (``stage_table``,
    unpacked: a cast, where a quad-pack would also write 4x the bytes) and
    sample them with ``bilerp_fwd_unpacked`` (the staged width's padded
    columns dropped).  Backward: the unpacked backward kernel for every
    table, [H*W, F] f32 straight into the grid's gradient; and, only when
    the fractions need a gradient (the camera optimizer's steps), one
    ``bilerp_bwd_coords`` launch over the staged tables, which the forward
    then keeps.  Row ids get no gradient."""

    @staticmethod
    def forward(ctx, n, ty, *tensors):
        grids, rowids, txs = _split(n, tensors)
        h, w, feat = grids[0].shape
        tables = [stage_table(g) for g in grids]
        feats = pk.bilerp_fwd_unpacked(tables, rowids, txs, ty, h=h, w=w)
        coords = _needs_coord_grads(ctx, n)
        ctx.save_for_backward(ty, *rowids, *txs, *(tables if coords else ()))
        ctx.shape = (n, h, w, feat)
        return tuple(f if f.shape[1] == feat else f[:, :feat] for f in feats)

    @staticmethod
    def backward(ctx, *gouts):
        n, h, w, feat = ctx.shape
        ty, *rest = ctx.saved_tensors
        rowids, txs, tables = rest[:n], rest[n:2 * n], rest[2 * n:]
        need = [i for i in range(n) if ctx.needs_input_grad[2 + i]]
        grads = pk.bilerp_bwd_unpacked(
            [gouts[i].contiguous() for i in need], [rowids[i] for i in need],
            [txs[i] for i in need], ty, h=h, w=w) if need else []
        out = [None] * n
        for i, g in zip(need, grads):
            out[i] = g.reshape(h, w, feat)
        d_txs, d_ty = _coord_grads(ctx, tables, gouts, rowids, txs, ty, h, w)
        return (None, d_ty, *out, *([None] * n), *d_txs)


class _PackedGroup(torch.autograd.Function):
    """Forward: bilerp_fwd_packed on the quad-packed tables cast to bf16.
    Backward: bilerp_bwd_packed, f32 [R, 4F] per table; and, only when the
    fractions need a gradient, one ``bilerp_bwd_coords`` launch over the
    bf16 tables, which the forward then keeps.  Row ids get no gradient."""

    @staticmethod
    def forward(ctx, n, ty, *tensors):
        tables, rowids, txs = _split(n, tensors)
        staged = [t.to(torch.bfloat16).contiguous() for t in tables]
        feats = pk.bilerp_fwd_packed(staged, rowids, txs, ty)
        coords = _needs_coord_grads(ctx, n)
        ctx.save_for_backward(ty, *rowids, *txs, *(staged if coords else ()))
        ctx.shape = (n, tables[0].shape[0])
        return tuple(feats)

    @staticmethod
    def backward(ctx, *gouts):
        n, rows = ctx.shape
        ty, *rest = ctx.saved_tensors
        rowids, txs, staged = rest[:n], rest[n:2 * n], rest[2 * n:]
        need = [i for i in range(n) if ctx.needs_input_grad[2 + i]]
        grads = pk.bilerp_bwd_packed(
            [gouts[i].contiguous() for i in need], [rowids[i] for i in need],
            [txs[i] for i in need], ty, rows=rows) if need else []
        out = [None] * n
        for i, g in zip(need, grads):
            out[i] = g
        # a packed table names its rows only; the kernel reads whole rows
        d_txs, d_ty = _coord_grads(ctx, staged, gouts, rowids, txs, ty, rows, 1)
        return (None, d_ty, *out, *([None] * n), *d_txs)


def plane_sample_fold_group(grids: Sequence[torch.Tensor], rowids, txs,
                            ty: torch.Tensor) -> List[torch.Tensor]:
    """Differentiable bilinear sample of P same-shaped f32 [H, W, F] planes
    that share their y axis: gradients reach the grids and, where they
    require one, the fractions.

    Args:
        grids: P [H, W, F] f32; rowids: P [M] int32 (y0*W + x0, any
            order; no gradient); txs: P [M] f32; ty: [M] f32.
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
        tables: P [R, 4F] f32; rowids, txs, ty: as plane_sample_fold_group
            (the fractions' gradients included).
    Returns:
        P [M, F] f32 features.
    """
    return list(_PackedGroup.apply(len(tables), ty, *tables, *rowids, *txs))
