"""Bilinear plane-sampling kernels: CUDA wrappers, plain versions, launch
counters.

Forward (``csrc/plane_kernels.cu``): ``bilerp_fwd_unpacked`` replaces
``unpacked_bilerp_fwd_group`` and ``bilerp_fwd_packed`` replaces
``packed_bilerp_fwd_group`` (soccernerfs_tpu/ops/pallas/plane_kernels.py).
Backward (``csrc/plane_bwd_kernels.cu``): ``bilerp_bwd_unpacked`` replaces
``bilerp_bwd_group_fold`` and ``bilerp_bwd_packed`` replaces
``packed_bilerp_bwd_group``.  The sources state each kernel's bound on the
card and what its design does about it.

The render path's forward (``csrc/plane_kernels.cu``) is
``kplanes_fwd_fused``: one launch per K-Planes scale derives every plane's
cell and fractions from the normalised points, gathers and lerps up to six
staged tables of either layout, multiplies them and writes the scale's
features into its column slice of the concatenated output.  It replaces
both forward kernels on the render path (the train path keeps them: its
autograd graph needs each plane's factor).

Each other wrapper takes P planes of one table shape that share their y axis,
with a row id and x fraction per point and plane and one y fraction per
point.  The forward wrappers return P f32 [M, F] features; the backward
wrappers take P f32 [M, F] upstream gradients and return P f32 table
gradients.  For CPU tensors a wrapper runs its plain version (the CPU
tests' path); for CUDA tensors it launches its kernel or raises.
``<wrapper>.launches`` counts kernel launches, and nothing else.

Unlike the TPU kernels, these take points in any order: a CUDA thread
gathers (or atomically scatters) directly, so the stripe sort the TPU
needed does not exist here.  The backward kernels sum runs of equal row
ids in registers before their atomics, so points in ray order (the train
path's) cost fewer of them.
"""
from __future__ import annotations

import ctypes
from typing import List, Sequence

import torch

from soccernerfs_tpu_torch.ops.kernels import build

MAX_PLANES = 3
MAX_FUSED_PLANES = 6
FEATS = (8, 32)


# ---------------------------------------------------------------------------
# plain versions (the same arithmetic, one PyTorch op at a time)
# ---------------------------------------------------------------------------

def grid_coords(coords_1d: torch.Tensor, size: int):
    """[-1, 1] -> (cell int32, frac f32) with align_corners/border
    clamping: the continuous coordinate clamps first, so x = size - 1
    gives cell size - 1 and fraction 0."""
    v = torch.clamp((coords_1d + 1.0) * 0.5 * (size - 1), 0.0, size - 1)
    c = torch.floor(v)
    return c.to(torch.int32), v - c


def lerp_corners(p00, p01, p10, p11, tx, ty) -> torch.Tensor:
    """f32 bilinear lerp of [M, F] corner rows (bf16 or f32) with [M]
    fractions, in the kernels' order of operations."""
    txc = tx[:, None]
    tyc = ty[:, None]
    top = p00 * (1.0 - txc) + p01 * txc
    bot = p10 * (1.0 - txc) + p11 * txc
    return top * (1.0 - tyc) + bot * tyc


def packed_rows_plain(table, rowid, tx, ty) -> torch.Tensor:
    """One plane of bilerp_fwd_packed: gather quad-packed rows (row ids
    clipped into the table, as JAX's ``take(mode="clip")``) and lerp."""
    feat = table.shape[1] // 4
    rows = table[torch.clamp(rowid.long(), 0, table.shape[0] - 1)]
    return lerp_corners(
        rows[:, :feat], rows[:, feat:2 * feat],
        rows[:, 2 * feat:3 * feat], rows[:, 3 * feat:], tx, ty,
    )


def bilerp_fwd_packed_plain(tables, rowids, txs, ty) -> List[torch.Tensor]:
    """Plain version of bilerp_fwd_packed."""
    return [packed_rows_plain(t, r, tx, ty)
            for t, r, tx in zip(tables, rowids, txs)]


def corner_rows(rowid, *, h: int, w: int):
    """Rows (y0, x0), (y0, x1), (y1, x0), (y1, x1) of an [h*w, F] table
    for row ids y0*w + x0 (clipped into the table), x1 = min(x0+1, w-1),
    y1 = min(y0+1, h-1): the border replicates."""
    row = torch.clamp(rowid.long(), 0, h * w - 1)
    y0 = torch.div(row, w, rounding_mode="floor")
    dx = (row - y0 * w < w - 1).long()
    dy = (y0 < h - 1).long() * w
    return row, row + dx, row + dy, row + dy + dx


def bilerp_fwd_unpacked_plain(tables, rowids, txs, ty, *, h: int, w: int
                              ) -> List[torch.Tensor]:
    """Plain version of bilerp_fwd_unpacked: the four corner rows of an
    [h*w, F] table (``corner_rows``), lerped."""
    outs = []
    for table, rowid, tx in zip(tables, rowids, txs):
        r00, r01, r10, r11 = corner_rows(rowid, h=h, w=w)
        outs.append(lerp_corners(table[r00], table[r01], table[r10],
                                 table[r11], tx, ty))
    return outs


def kplanes_fwd_fused_plain(pts, tables, planes, out) -> torch.Tensor:
    """Plain version of kplanes_fwd_fused: per plane ``grid_coords`` of
    its two axes, the row id, the gather and lerp of its layout
    (``corner_rows`` or ``packed_rows_plain``), the product in the planes'
    order, written into ``out``."""
    feat = out.shape[1]
    acc = None
    for table, (c1, c2, h, w) in zip(tables, planes):
        xc, tx = grid_coords(pts[:, c1], w)
        yc, ty = grid_coords(pts[:, c2], h)
        rowid = yc * w + xc
        if table.shape[1] == feat:
            r00, r01, r10, r11 = corner_rows(rowid, h=h, w=w)
            f = lerp_corners(table[r00], table[r01], table[r10], table[r11],
                             tx, ty)
        else:
            f = packed_rows_plain(table, rowid, tx, ty)
        acc = f if acc is None else acc.mul_(f)
    out.copy_(acc)
    return out


def corner_weights(tx, ty):
    """[M] bilinear weights of the corners (y0, x0), (y0, x1), (y1, x0),
    (y1, x1), each a product of two rounded factors, as the backward
    kernels compute them."""
    omtx = 1.0 - tx
    omty = 1.0 - ty
    return omtx * omty, tx * omty, omtx * ty, tx * ty


def bilerp_bwd_unpacked_plain(gs, rowids, txs, ty, *, h: int, w: int
                              ) -> List[torch.Tensor]:
    """Plain version of bilerp_bwd_unpacked: the f32 transpose of
    bilerp_fwd_unpacked, ``index_add_`` of g * weight into each corner row
    (two corners on a border are one row, so both terms land there)."""
    outs = []
    for g, rowid, tx in zip(gs, rowids, txs):
        grad = torch.zeros((h * w, g.shape[1]), dtype=torch.float32,
                           device=g.device)
        for rows, wt in zip(corner_rows(rowid, h=h, w=w),
                            corner_weights(tx, ty)):
            grad.index_add_(0, rows, g * wt[:, None])
        outs.append(grad)
    return outs


def bilerp_bwd_packed_plain(gs, rowids, txs, ty, *, rows: int
                            ) -> List[torch.Tensor]:
    """Plain version of bilerp_bwd_packed: the f32 transpose of
    bilerp_fwd_packed, quarter k of row ``rowid`` of an [R, 4F] table
    getting g * w_k."""
    outs = []
    for g, rowid, tx in zip(gs, rowids, txs):
        row = torch.clamp(rowid.long(), 0, rows - 1)
        grad = torch.zeros((rows, 4 * g.shape[1]), dtype=torch.float32,
                           device=g.device)
        grad.index_add_(0, row, torch.cat(
            [g * wt[:, None] for wt in corner_weights(tx, ty)], dim=1))
        outs.append(grad)
    return outs


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

_P = ctypes.POINTER(ctypes.c_void_p)
_POINTS = [ctypes.c_int, _P, _P, _P, ctypes.c_void_p, _P, ctypes.c_longlong]
# function -> (library, the arguments after the shared ones, then feat and
# the stream)
_SIGNATURES = {
    "snt_bilerp_fwd_unpacked": ("plane_kernels", [ctypes.c_int, ctypes.c_int]),
    "snt_bilerp_fwd_packed": ("plane_kernels", [ctypes.c_longlong]),
    "snt_bilerp_bwd_unpacked": ("plane_bwd_kernels",
                                [ctypes.c_int, ctypes.c_int]),
    "snt_bilerp_bwd_packed": ("plane_bwd_kernels", [ctypes.c_longlong]),
}
LIBRARIES = ("plane_kernels", "plane_bwd_kernels")


def _fn(name: str):
    lib_name, shape_args = _SIGNATURES[name]
    fn = getattr(build.load(lib_name), name)
    fn.argtypes = [*_POINTS, *shape_args, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _on_cpu(tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _check(ins, rowids, txs, ty, dtype) -> int:
    """Validate a CUDA launch's operands: P contiguous 2-D ``dtype``
    tensors of one shape (tables, or upstream gradients) and the per-point
    arrays; returns M."""
    planes = len(ins)
    if not 1 <= planes <= MAX_PLANES:
        raise ValueError(f"1..{MAX_PLANES} planes per launch, got {planes}")
    if not len(rowids) == len(txs) == planes:
        raise ValueError("one row id and tx array per plane")
    dev = ins[0].device
    if dev.type != "cuda":
        raise ValueError(f"kernel operands must be CUDA tensors, got {dev}")
    for t in ins:
        if t.dtype != dtype or t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"tables and gradients must be contiguous 2-D {dtype}")
        if t.shape != ins[0].shape or t.device != dev:
            raise ValueError("tables of one launch share shape and device")
        if t.data_ptr() % 16:
            raise ValueError("tables and gradients must be 16-byte aligned")
    m = rowids[0].shape[0]
    for arrs, want in ((rowids, torch.int32), (txs, torch.float32),
                       ([ty], torch.float32)):
        for a in arrs:
            if (a.dtype != want or a.shape != (m,) or a.device != dev
                    or not a.is_contiguous()):
                raise ValueError(f"per-point operands must be contiguous "
                                 f"{want} [{m}] on {dev}")
    return m


def _check_feat(feat: int) -> None:
    if feat not in FEATS:
        raise ValueError(f"feature width must be one of {FEATS}, got {feat}")


def _ptrs(tensors) -> ctypes.Array:
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def _launch(name, ins, rowids, txs, ty, outs, m, feat, *shape_args) -> None:
    """Launch ``name`` on the current stream of the operands' device; the
    caller allocated ``outs``."""
    dev = ins[0].device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _fn(name)(
            len(ins), _ptrs(ins), _ptrs(rowids), _ptrs(txs), ty.data_ptr(),
            _ptrs(outs), m, *shape_args, feat, stream,
        )
    if err != 0:
        raise RuntimeError(f"{name} failed to launch: CUDA error {err}")


def bilerp_fwd_unpacked(tables: Sequence[torch.Tensor], rowids, txs,
                        ty: torch.Tensor, *, h: int, w: int
                        ) -> List[torch.Tensor]:
    """Bilinear sample of P [h*w, F] bf16 tables (the planes themselves).

    Args:
        tables: P [h*w, F] bf16, F in {8, 32}.
        rowids: P [M] int32 row ids y0*w + x0; txs: P [M] f32;
        ty: [M] f32, shared by the P planes.
    Returns:
        P [M, F] f32.
    """
    if _on_cpu([*tables, *rowids, *txs, ty]):
        return bilerp_fwd_unpacked_plain(tables, rowids, txs, ty, h=h, w=w)
    m = _check(tables, rowids, txs, ty, torch.bfloat16)
    feat = tables[0].shape[-1]
    _check_feat(feat)
    if tables[0].shape[0] != h * w:
        raise ValueError(f"table has {tables[0].shape[0]} rows, want {h * w}")
    outs = [torch.empty((m, feat), dtype=torch.float32, device=ty.device)
            for _ in tables]
    if m == 0:
        return outs
    _launch("snt_bilerp_fwd_unpacked", tables, rowids, txs, ty, outs, m, feat,
            h, w)
    bilerp_fwd_unpacked.launches += 1
    return outs


bilerp_fwd_unpacked.launches = 0


def bilerp_fwd_packed(tables: Sequence[torch.Tensor], rowids, txs,
                      ty: torch.Tensor) -> List[torch.Tensor]:
    """Bilinear sample of P quad-packed [R, 4F] bf16 tables.

    Args:
        tables: P [R, 4F] bf16 (ops/grid_sample.quad_pack), F in {8, 32}.
        rowids: P [M] int32 row ids; txs: P [M] f32; ty: [M] f32.
    Returns:
        P [M, F] f32.
    """
    if _on_cpu([*tables, *rowids, *txs, ty]):
        return bilerp_fwd_packed_plain(tables, rowids, txs, ty)
    m = _check(tables, rowids, txs, ty, torch.bfloat16)
    if tables[0].shape[-1] % 4:
        raise ValueError("packed tables are [R, 4F]")
    feat = tables[0].shape[-1] // 4
    _check_feat(feat)
    outs = [torch.empty((m, feat), dtype=torch.float32, device=ty.device)
            for _ in tables]
    if m == 0:
        return outs
    _launch("snt_bilerp_fwd_packed", tables, rowids, txs, ty, outs, m, feat,
            tables[0].shape[0])
    bilerp_fwd_packed.launches += 1
    return outs


bilerp_fwd_packed.launches = 0


def _check_fused(pts, tables, planes, out) -> None:
    """Validate a fused launch's operands (see kplanes_fwd_fused)."""
    if not 1 <= len(tables) <= MAX_FUSED_PLANES:
        raise ValueError(f"1..{MAX_FUSED_PLANES} planes per launch, got "
                         f"{len(tables)}")
    if len(planes) != len(tables):
        raise ValueError("one (c1, c2, h, w) per table")
    dev = pts.device
    if dev.type != "cuda":
        raise ValueError(f"kernel operands must be CUDA tensors, got {dev}")
    if (pts.dtype != torch.float32 or pts.dim() != 2
            or pts.shape[1] not in (3, 4) or not pts.is_contiguous()):
        raise ValueError("points must be contiguous f32 [M, 3] or [M, 4]")
    feat = out.shape[-1] if out.dim() == 2 else -1
    _check_feat(feat)
    if (out.dtype != torch.float32 or out.shape[0] != pts.shape[0]
            or out.stride(1) != 1 or out.stride(0) % 4
            or out.data_ptr() % 16 or out.device != dev):
        raise ValueError(f"out must be f32 [{pts.shape[0]}, F] with unit "
                         f"column stride and 16-byte aligned rows on {dev}")
    for t, (c1, c2, h, w) in zip(tables, planes):
        if not (0 <= c1 < pts.shape[1] and 0 <= c2 < pts.shape[1]
                and h >= 1 and w >= 1):
            raise ValueError(f"plane (c1, c2, h, w) = {(c1, c2, h, w)} does "
                             f"not fit [M, {pts.shape[1]}] points")
        if (t.dtype != torch.bfloat16 or t.dim() != 2 or not t.is_contiguous()
                or t.device != dev or t.data_ptr() % 16):
            raise ValueError("tables must be contiguous 16-byte aligned bf16 "
                             f"2-D tensors on {dev}")
        if t.shape[0] != h * w or t.shape[1] not in (feat, 4 * feat):
            raise ValueError(f"a table of {list(t.shape)} is neither [{h * w},"
                             f" {feat}] nor [{h * w}, {4 * feat}]")


def _launch_fused(pts, tables, planes, out) -> None:
    """Launch snt_kplanes_fwd_fused on the current stream of the operands'
    device (checked by _check_fused)."""
    feat = out.shape[1]
    fn = build.load("plane_kernels").snt_kplanes_fwd_fused
    ints = ctypes.c_int * len(tables)
    fn.argtypes = [ctypes.c_int, _P, *[ctypes.POINTER(ctypes.c_int)] * 5,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    packed = ints(*[int(t.shape[1] != feat) for t in tables])
    # (c1, c2, h, w) per plane -> the h, w, c1 and c2 arrays
    hs, ws, c1s, c2s = (ints(*[int(p[k]) for p in planes]) for k in (2, 3, 0, 1))
    with torch.cuda.device(pts.device):
        stream = torch.cuda.current_stream(pts.device).cuda_stream
        err = fn(len(tables), _ptrs(tables), packed, hs, ws, c1s, c2s,
                 pts.data_ptr(), pts.shape[1], out.data_ptr(), out.stride(0),
                 pts.shape[0], feat, stream)
    if err != 0:
        raise RuntimeError(f"snt_kplanes_fwd_fused failed to launch: CUDA "
                           f"error {err}")


def kplanes_fwd_fused(pts: torch.Tensor, tables: Sequence[torch.Tensor],
                      planes, out: torch.Tensor) -> torch.Tensor:
    """One K-Planes scale's features, the product of its planes' bilinear
    samples in the order given, written into ``out``.

    Args:
        pts: [M, D] f32 normalised coordinates, D in {3, 4}.
        tables: P <= 6 staged bf16 tables (ops/grid_sample.stage_table),
            each [h*w, F] (unpacked) or [h*w, 4F] (quad-packed).
        planes: P (c1, c2, h, w): the coordinates indexing a plane's width
            and height, and its shape.
        out: [M, F] f32, F in {8, 32}, unit column stride (a column slice
            of the [M, S*F] concatenated features).
    Returns:
        ``out``.
    """
    if _on_cpu([pts, *tables, out]):
        return kplanes_fwd_fused_plain(pts, tables, planes, out)
    _check_fused(pts, tables, planes, out)
    if pts.shape[0] == 0:
        return out
    _launch_fused(pts, tables, planes, out)
    kplanes_fwd_fused.launches += 1
    return out


kplanes_fwd_fused.launches = 0


def _check_grads(gs, rowids, txs, ty) -> tuple:
    """Validate a backward launch's operands; returns (M, F)."""
    m = _check(gs, rowids, txs, ty, torch.float32)
    feat = gs[0].shape[1]
    _check_feat(feat)
    if gs[0].shape[0] != m:
        raise ValueError(f"gradients have {gs[0].shape[0]} rows, want {m}")
    return m, feat


def bilerp_bwd_unpacked(gs: Sequence[torch.Tensor], rowids, txs,
                        ty: torch.Tensor, *, h: int, w: int
                        ) -> List[torch.Tensor]:
    """Gradient of bilerp_fwd_unpacked w.r.t. its P [h*w, F] tables.

    Args:
        gs: P [M, F] f32 upstream gradients, F in {8, 32};
        rowids, txs, ty: as bilerp_fwd_unpacked.
    Returns:
        P [h*w, F] f32 table gradients.
    """
    if _on_cpu([*gs, *rowids, *txs, ty]):
        return bilerp_bwd_unpacked_plain(gs, rowids, txs, ty, h=h, w=w)
    m, feat = _check_grads(gs, rowids, txs, ty)
    grads = [torch.zeros((h * w, feat), dtype=torch.float32, device=ty.device)
             for _ in gs]
    if m == 0:
        return grads
    _launch("snt_bilerp_bwd_unpacked", gs, rowids, txs, ty, grads, m, feat,
            h, w)
    bilerp_bwd_unpacked.launches += 1
    return grads


bilerp_bwd_unpacked.launches = 0


def bilerp_bwd_packed(gs: Sequence[torch.Tensor], rowids, txs,
                      ty: torch.Tensor, *, rows: int) -> List[torch.Tensor]:
    """Gradient of bilerp_fwd_packed w.r.t. its P quad-packed tables.

    Args:
        gs: P [M, F] f32 upstream gradients, F in {8, 32};
        rowids, txs, ty: as bilerp_fwd_packed; rows: R.
    Returns:
        P [R, 4F] f32 table gradients.
    """
    if _on_cpu([*gs, *rowids, *txs, ty]):
        return bilerp_bwd_packed_plain(gs, rowids, txs, ty, rows=rows)
    m, feat = _check_grads(gs, rowids, txs, ty)
    grads = [torch.zeros((rows, 4 * feat), dtype=torch.float32,
                         device=ty.device) for _ in gs]
    if m == 0:
        return grads
    _launch("snt_bilerp_bwd_packed", gs, rowids, txs, ty, grads, m, feat, rows)
    bilerp_bwd_packed.launches += 1
    return grads


bilerp_bwd_packed.launches = 0

# the train path's kernels (its forward keeps every plane's factor for the
# backward), then the render path's
TRAIN_KERNELS = (bilerp_fwd_unpacked, bilerp_fwd_packed, bilerp_bwd_unpacked,
                 bilerp_bwd_packed)
KERNELS = (*TRAIN_KERNELS, kplanes_fwd_fused)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
