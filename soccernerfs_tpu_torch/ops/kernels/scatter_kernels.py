"""Row scatter-add, the hash grids' table gradient: CUDA wrapper, plain
version, launch counter.

``scatter_add_rows`` (``csrc/scatter_kernels.cu``) replaces
``sorted_scatter_add`` (soccernerfs_tpu/ops/pallas/plane_kernels.py).  The
source states the kernel's bound on the card and what its design does
about it.

The TPU kernel takes the expanded, sorted update stream ``[K*B, c]``.  This
one takes what the encoder's backward holds: the upstream gradient
``g [B, G*c]`` of G levels of one table, the corner rows ``idxs [G, K, B]``
and the corner weights ``ws [G, K, B]``, and adds ``ws[j, k, b] *
g[b, j*c:(j+1)*c]`` to row ``idxs[j, k, b]`` of an f32 ``[rows, c]`` table,
in any order of indices.  With G = K = 1 and no weights it is
``sorted_scatter_add`` itself.

For CPU tensors the wrapper runs its plain version (the CPU tests' path);
for CUDA tensors it launches its kernel or raises.
``scatter_add_rows.launches`` counts kernel launches, and nothing else.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from soccernerfs_tpu_torch.ops.kernels import build

# the row widths sorted_scatter_add accepts
CHANNELS = (1, 2, 4, 8, 16, 32, 128)
LIBRARIES = ("scatter_kernels",)


def _shapes(g, idxs, ws, rows) -> tuple:
    """Validate the operands' shapes and types; returns (G, K, B, c)."""
    if idxs.dim() != 3 or idxs.dtype != torch.int32:
        raise ValueError("idxs must be int32 [groups, corners, points]")
    groups, corners, points = idxs.shape
    if g.dim() != 2 or g.dtype != torch.float32 or g.shape[0] != points:
        raise ValueError(f"g must be f32 [{points}, groups * c], got "
                         f"{g.dtype} {list(g.shape)}")
    if groups < 1 or corners < 1 or g.shape[1] % groups:
        raise ValueError(f"g's width {g.shape[1]} does not split into "
                         f"{groups} groups")
    c = g.shape[1] // groups
    if c not in CHANNELS:
        raise ValueError(f"row width must be one of {CHANNELS}, got {c}")
    if ws is not None and (ws.dtype != torch.float32 or ws.shape != idxs.shape):
        raise ValueError("ws must be f32 of idxs' shape")
    if rows < 1 or rows * c >= 1 << 31:
        raise ValueError(f"table of {rows} rows x {c} is out of range")
    return groups, corners, points, c


def _raise_out_of_range(rows: int):
    raise IndexError(f"scatter_add_rows: a row index lies outside [0, {rows})")


def scatter_add_rows_plain(g: torch.Tensor, idxs: torch.Tensor,
                           ws: Optional[torch.Tensor] = None, *, rows: int
                           ) -> torch.Tensor:
    """Plain version of scatter_add_rows: one ``index_add_`` of the
    expanded updates into an f32 zero table."""
    groups, corners, points, c = _shapes(g, idxs, ws, rows)
    out = torch.zeros((rows, c), dtype=torch.float32, device=g.device)
    if points == 0:
        return out
    if int(idxs.min()) < 0 or int(idxs.max()) >= rows:
        _raise_out_of_range(rows)
    upd = g.view(points, groups, 1, c).permute(1, 2, 0, 3)       # [G, 1, B, c]
    if ws is not None:
        upd = upd * ws[..., None]
    upd = upd.expand(groups, corners, points, c)
    return out.index_add_(0, idxs.reshape(-1).long(), upd.reshape(-1, c))


def _on_cpu(tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _check_cuda(operands) -> None:
    """Validate a CUDA launch's operands: one CUDA device, contiguous,
    16-byte aligned."""
    dev = operands[0].device
    for t in operands:
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"kernel operands must share one CUDA device, "
                             f"got {t.device} and {dev}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("kernel operands must be contiguous and "
                             "16-byte aligned")


def _fn():
    fn = build.load(LIBRARIES[0]).snt_scatter_add_rows
    fn.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(g, idxs, ws, out, flag, points, groups, corners, c, rows) -> None:
    """Launch the kernel on the current stream of the operands' device; the
    caller allocated ``out`` (zeros) and ``flag`` (one int32 zero)."""
    dev = g.device
    with torch.cuda.device(dev):
        err = _fn()(
            g.data_ptr(), idxs.data_ptr(),
            None if ws is None else ws.data_ptr(), out.data_ptr(),
            flag.data_ptr(), points, groups, corners, c, rows,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"snt_scatter_add_rows failed to launch: CUDA "
                           f"error {err}")


def scatter_add_rows(g: torch.Tensor, idxs: torch.Tensor,
                     ws: Optional[torch.Tensor] = None, *, rows: int
                     ) -> torch.Tensor:
    """``out[r] = sum of ws[j, k, b] * g[b, j*c:(j+1)*c]`` over the updates
    with ``idxs[j, k, b] == r``.

    Args:
        g: [B, G*c] f32, c in CHANNELS: per point, G groups of c channels.
        idxs: [G, K, B] int32 rows in [0, rows), in any order.
        ws: [G, K, B] f32 weights, or None for 1.
        rows: table rows.
    Returns:
        [rows, c] f32.
    Raises:
        IndexError: an index lies outside [0, rows).  On the card the kernel
            drops such an update and raises a flag; reading it waits for
            the kernel.
    """
    operands = [g, idxs] + ([] if ws is None else [ws])
    if _on_cpu(operands):
        return scatter_add_rows_plain(g, idxs, ws, rows=rows)
    groups, corners, points, c = _shapes(g, idxs, ws, rows)
    _check_cuda(operands)
    dev = g.device
    out = torch.zeros((rows, c), dtype=torch.float32, device=dev)
    if points == 0:
        return out
    flag = torch.zeros(1, dtype=torch.int32, device=dev)
    _launch(g, idxs, ws, out, flag, points, groups, corners, c, rows)
    scatter_add_rows.launches += 1
    if int(flag):
        _raise_out_of_range(rows)
    return out


scatter_add_rows.launches = 0

KERNELS = (scatter_add_rows,)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
