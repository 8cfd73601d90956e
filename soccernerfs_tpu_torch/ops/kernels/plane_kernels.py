"""Bilinear plane-sampling forward kernels: CUDA wrappers, plain versions,
launch counters.

``bilerp_fwd_unpacked`` replaces ``unpacked_bilerp_fwd_group`` and
``bilerp_fwd_packed`` replaces ``packed_bilerp_fwd_group``
(soccernerfs_tpu/ops/pallas/plane_kernels.py).  The kernels are in
``csrc/plane_kernels.cu``, which also states their bound on the card and
what the design does about it.

Each wrapper takes P planes of one table shape that share their y axis,
with a row id and x fraction per point and plane and one y fraction per
point, and returns P f32 [M, F] features.  For
CPU tensors it runs its plain version (the CPU tests' path); for CUDA
tensors it launches its kernel or raises.  ``<wrapper>.launches`` counts
kernel launches, and nothing else.

Unlike the TPU kernels, these take points in any order: a CUDA thread
gathers directly, so the stripe sort the TPU needed does not exist here.
"""
from __future__ import annotations

import ctypes
from typing import List, Sequence

import torch

from soccernerfs_tpu_torch.ops.kernels import build

MAX_PLANES = 3
FEATS = (8, 32)


# ---------------------------------------------------------------------------
# plain versions (the same arithmetic, one PyTorch op at a time)
# ---------------------------------------------------------------------------

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


def bilerp_fwd_unpacked_plain(tables, rowids, txs, ty, *, h: int, w: int
                              ) -> List[torch.Tensor]:
    """Plain version of bilerp_fwd_unpacked: corners (y0, x0), (y0, x1),
    (y1, x0), (y1, x1) of an [h*w, F] table, x1 = min(x0+1, w-1),
    y1 = min(y0+1, h-1)."""
    outs = []
    for table, rowid, tx in zip(tables, rowids, txs):
        row = torch.clamp(rowid.long(), 0, h * w - 1)
        y0 = torch.div(row, w, rounding_mode="floor")
        x0 = row - y0 * w
        dx = (x0 < w - 1).long()
        dy = (y0 < h - 1).long() * w
        outs.append(lerp_corners(
            table[row], table[row + dx], table[row + dy], table[row + dy + dx],
            tx, ty,
        ))
    return outs


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

_P = ctypes.POINTER(ctypes.c_void_p)
_SIGNATURES = {
    "snt_bilerp_fwd_unpacked": [
        ctypes.c_int, _P, _P, _P, ctypes.c_void_p, _P,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ],
    "snt_bilerp_fwd_packed": [
        ctypes.c_int, _P, _P, _P, ctypes.c_void_p, _P,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
    ],
}


def _fn(name: str):
    lib = build.load("plane_kernels")
    fn = getattr(lib, name)
    fn.argtypes = _SIGNATURES[name]
    fn.restype = ctypes.c_int
    return fn


def _on_cpu(tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _check(tables, rowids, txs, ty, feat: int):
    """Validate a CUDA launch's operands; returns (M, F)."""
    planes = len(tables)
    if not 1 <= planes <= MAX_PLANES:
        raise ValueError(f"1..{MAX_PLANES} planes per launch, got {planes}")
    if not len(rowids) == len(txs) == planes:
        raise ValueError("one row id and tx array per plane")
    dev = tables[0].device
    if dev.type != "cuda":
        raise ValueError(f"kernel operands must be CUDA tensors, got {dev}")
    m = rowids[0].shape[0]
    for t in tables:
        if t.dtype != torch.bfloat16 or t.dim() != 2 or not t.is_contiguous():
            raise ValueError("tables must be contiguous 2-D bf16")
        if t.shape != tables[0].shape or t.device != dev:
            raise ValueError("tables of one launch share shape and device")
        if t.data_ptr() % 16:
            raise ValueError("tables must be 16-byte aligned")
    for arrs, dtype in ((rowids, torch.int32), (txs, torch.float32),
                        ([ty], torch.float32)):
        for a in arrs:
            if (a.dtype != dtype or a.shape != (m,) or a.device != dev
                    or not a.is_contiguous()):
                raise ValueError(f"per-point operands must be contiguous "
                                 f"{dtype} [{m}] on {dev}")
    if feat not in FEATS:
        raise ValueError(f"feature width must be one of {FEATS}, got {feat}")
    return m, feat


def _ptrs(tensors) -> ctypes.Array:
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def _launch(name, tables, rowids, txs, ty, m, feat, *shape_args):
    dev = tables[0].device
    outs = [torch.empty((m, feat), dtype=torch.float32, device=dev)
            for _ in tables]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _fn(name)(
            len(tables), _ptrs(tables), _ptrs(rowids), _ptrs(txs),
            ty.data_ptr(), _ptrs(outs), m, *shape_args, feat, stream,
        )
    if err != 0:
        raise RuntimeError(f"{name} failed to launch: CUDA error {err}")
    return outs


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
    m, feat = _check(tables, rowids, txs, ty, tables[0].shape[-1])
    if tables[0].shape[0] != h * w:
        raise ValueError(f"table has {tables[0].shape[0]} rows, want {h * w}")
    if m == 0:
        return [torch.empty((0, feat), device=tables[0].device)
                for _ in tables]
    outs = _launch("snt_bilerp_fwd_unpacked", tables, rowids, txs, ty, m,
                   feat, h, w)
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
    if tables[0].shape[-1] % 4:
        raise ValueError("packed tables are [R, 4F]")
    m, feat = _check(tables, rowids, txs, ty, tables[0].shape[-1] // 4)
    if m == 0:
        return [torch.empty((0, feat), device=tables[0].device)
                for _ in tables]
    outs = _launch("snt_bilerp_fwd_packed", tables, rowids, txs, ty, m,
                   feat, tables[0].shape[0])
    bilerp_fwd_packed.launches += 1
    return outs


bilerp_fwd_packed.launches = 0

KERNELS = (bilerp_fwd_unpacked, bilerp_fwd_packed)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
