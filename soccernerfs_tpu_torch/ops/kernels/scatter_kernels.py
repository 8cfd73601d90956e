"""Row scatter-add, the hash grids' table gradient: CUDA wrapper, plain
version, launch counter, deferred range check, and the count of the
kernel's atomic operations.

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
from typing import Dict, Optional

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
    expanded updates (each product rounded in f32, as the kernel rounds
    it) into an f64 zero table, rounded to f32 once.  Summed in f32 with
    atomics, the card's ``index_add_`` strays by up to ~3e-6 of a row's sum
    of |terms| on the rows of the train step's proposal grids that take
    10,000-40,000 updates, more than the kernel does; the f64 sum keeps the
    reference's own error out of the comparison."""
    groups, corners, points, c = _shapes(g, idxs, ws, rows)
    out = torch.zeros((rows, c), dtype=torch.float64, device=g.device)
    if points == 0:
        return out.float()
    if int(idxs.min()) < 0 or int(idxs.max()) >= rows:
        _raise_out_of_range(rows)
    upd = g.view(points, groups, 1, c).permute(1, 2, 0, 3)       # [G, 1, B, c]
    if ws is not None:
        upd = upd * ws[..., None]
    upd = upd.expand(groups, corners, points, c).reshape(-1, c).double()
    return out.index_add_(0, idxs.reshape(-1).long(), upd).float()


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
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(g, idxs, ws, out, flag, points, groups, corners, c, rows,
            window) -> None:
    """Launch the kernel on the current stream of the operands' device; the
    caller allocated ``out`` (zeros) and ``flag`` (the device's sticky
    int32); the table's first ``window`` rows are summed in shared
    memory."""
    dev = g.device
    with torch.cuda.device(dev):
        err = _fn()(
            g.data_ptr(), idxs.data_ptr(),
            None if ws is None else ws.data_ptr(), out.data_ptr(),
            flag.data_ptr(), points, groups, corners, c, rows, window,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"snt_scatter_add_rows failed to launch: CUDA "
                           f"error {err}")


# the shared-memory window of each block: 32 KB, level 0 (16^3 rows of 2
# channels) of every nerfacto grid, whose rows take the most updates
SHARED_BYTES = 32 * 1024


def shared_rows(rows: int, c: int) -> int:
    """Leading table rows the kernel sums in shared memory: as many as fit
    SHARED_BYTES, a whole number of 16-byte pieces (rows * c a multiple of
    4), at most the table."""
    n = min(rows, SHARED_BYTES // (4 * c))
    return n - n % (4 // min(c, 4))


# one int32 per CUDA device that the kernel sets when it drops an update
# whose row lies outside the table; raise_if_out_of_range reads and clears it
_FLAGS: Dict[torch.device, torch.Tensor] = {}


def _cuda_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _flag(dev: torch.device) -> torch.Tensor:
    dev = _cuda_device(dev)
    if dev not in _FLAGS:
        _FLAGS[dev] = torch.zeros(1, dtype=torch.int32, device=dev)
    return _FLAGS[dev]


def raise_if_out_of_range(device=None) -> None:
    """Raise ``IndexError`` if a ``scatter_add_rows`` launch on ``device``
    (default: the current CUDA device) met a row index outside its table
    since the last check, and clear the flag.  Reading the flag waits for
    those launches: call it where the caller synchronises anyway (after
    reading a step's loss).  No-op for the CPU, whose path raises at once."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type != "cuda" or not _FLAGS:
        return
    dev = _cuda_device(dev)
    flag = _FLAGS.get(dev)
    if flag is not None and int(flag):
        flag.zero_()
        raise IndexError(f"scatter_add_rows: a row index on {dev} lay outside "
                         f"its table (the update was dropped)")


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
        IndexError: on the CPU, at once when an index lies outside
            [0, rows).  On the card the range check is deferred, so that
            the wrapper never waits for the device: the kernel drops such
            an update and sets the device's sticky flag, and
            ``raise_if_out_of_range(device)`` raises.  A caller checks
            there before it trusts a table gradient, where it reads the
            step's loss (the train loop syncs there anyway).
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
    _launch(g, idxs, ws, out, _flag(dev), points, groups, corners, c, rows,
            shared_rows(rows, c))
    scatter_add_rows.launches += 1
    return out


scatter_add_rows.launches = 0

KERNELS = (scatter_add_rows,)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def scatter_plan(idxs: torch.Tensor, c: int, rows: int, *, strip: int,
                 threads: int, sms: int) -> dict:
    """The atomic operations ``snt_scatter_add_rows`` issues on these
    indices, counted from the operands (the kernel's strips, window and
    blocks, on the card's ``sms``; ``strip`` and ``threads`` as the built
    library reports them).

    Returns a dict: ``updates`` (G*K*B), ``flushes`` (the lanes' merged
    sums: per strip and corner, its first point and each point whose row
    differs from the one before, times the row's chunks of 4 channels),
    ``shared_adds`` (scalar shared-memory atomics), ``window_flushes``
    (16-byte window pieces the blocks touched, an upper bound: a piece that
    sums to zero is skipped) and ``l2_reductions`` (vector or scalar
    reductions into the table: window flushes plus the flushes of rows past
    the window).  Rows outside the table count nowhere.
    """
    groups, corners, points = idxs.shape
    window = shared_rows(rows, c)
    vec = min(c, 4)
    chunks = c // vec
    strips = -(-points // strip)
    items = groups * strips * corners * chunks
    blocks = max(1, min(sms, -(-items // threads)))

    r = idxs.long()
    start = torch.ones(r.shape, dtype=torch.bool, device=idxs.device)
    start[..., 1:] = r[..., 1:] != r[..., :-1]
    start[..., ::strip] = True
    runs = r[start]
    valid = (runs >= 0) & (runs < rows)
    inside = valid & (runs < window)
    # the window's pieces, per block: the blocks stride over the items
    at = start.nonzero()[inside]                            # j, k, b
    item = ((at[:, 0] * strips + at[:, 2] // strip) * corners
            + at[:, 1]) * chunks                            # chunk 0
    keys = [((item + q) // threads % blocks) * (window * c // 4 + 1)
            + (runs[inside] * c + q * vec) // 4 for q in range(chunks)]
    window_flushes = int(torch.cat(keys).unique().numel())
    flushes = int(start.sum()) * chunks
    return {
        "updates": groups * corners * points,
        "flushes": flushes,
        "shared_adds": c * int(inside.sum()),
        "window_flushes": window_flushes,
        "l2_reductions": chunks * int((valid & ~inside).sum()) + window_flushes,
    }
