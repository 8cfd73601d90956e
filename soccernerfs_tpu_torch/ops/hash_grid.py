"""Multi-level hash-grid encoders, static and temporal (counterpart of
soccernerfs_tpu/ops/hash_grid.py).

One flat ``[rows, level_dim + temporal_dim]`` table holds every level at
an offset.  A level whose dense grid fits its share of the table (and
every level of a ``tiled`` grid) is indexed by strides; the others hash
the lattice corner: ``xor`` is the torch-ngp prime-XOR hash, ``zline``
hashes the leading dimensions and adds the last one.  The row indices are
those of the JAX package bit for bit (a snapshot's table is only
meaningful under its hash), for any lattice coordinate: inputs outside
[0, 1] (a deformed point) give negative ones and ones beyond the
resolution.  zline's last step is a truncating remainder, as the JAX
package's ``lax.rem``, so a negative last coordinate can give a negative
level-local row; the encoder then reads the row that the JAX package's
CPU path reads, ``offset + row`` indexed into the whole table as Python
indexes (from its end when negative), and its gradient goes there too.
(The JAX package's TPU path clamps such a row to the level's first row
in its forward and drops its updates in its backward.)

Every level takes one path: the 2^D lattice corners of a point, their
rows and multilinear weights, ``out = sum_k ws[k] * table[idxs[k]]``, with
all levels of a grid computed together.  The JAX package's oct-packed
dense levels, roll-packed bf16 pair gathers and sorted update streams are
how a TPU computes the same function, and are not carried over; every
gather here reads the f32 table.

The gather-and-sum is a ``torch.autograd.Function``: its backward gives the
table gradient through ``scatter_add_rows`` (one launch for all levels of
the grid) and, when the weights require grad (positions that carry a
gradient, as under the camera optimizer), the weight gradient
``d_ws[k] = sum_c g * table[idxs[k]]``.

A temporal grid (``temporal_dim > 0``) slides a window over each row's
channels with time: output channel i of a level is ``w_a * row[ch_a] +
w_b * row[ch_b]``, the channels and weights a function of the time
(``get_temporal_index``).  So a point reads 2 * level_dim entries of each
corner's row, never the whole row: the forward gathers those picked
entries of the flattened table, and the table gradient is one
``scatter_add_rows`` launch of width 1 over ``[rows * C_row, 1]``, one
group per level whose "corners" are the (corner, picked entry) pairs.
Positions and times that require grad (the camera optimizer's steps) get
theirs through the corner weights and the time weights, whose gradients
the backward computes from the picked entries gathered again; the
registered methods detach both (``input_grads=False``).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from soccernerfs_tpu_torch.ops.kernels.scatter_kernels import scatter_add_rows

_PRIMES = (1, 2654435761, 805459861)
_MASK32 = 0xFFFFFFFF


@dataclass(frozen=True)
class HashGridConfig:
    """Field names and defaults are the JAX package's."""

    temporal_dim: int = 0  # 0: a static grid
    input_dim: int = 3
    num_levels: int = 16
    level_dim: int = 2
    per_level_scale: float = 2.0
    base_resolution: int = 16
    log2_hashmap_size: int = 19
    desired_resolution: Optional[int] = None
    gridtype: str = "hash"  # hash | tiled
    align_corners: bool = False
    hash_scheme: str = "xor"  # xor | zline

    @property
    def scale(self) -> float:
        if self.desired_resolution is not None:
            return float(
                np.exp2(
                    np.log2(self.desired_resolution / self.base_resolution)
                    / max(self.num_levels - 1, 1)
                )
            )
        return self.per_level_scale

    @property
    def output_dim(self) -> int:
        return self.num_levels * self.level_dim

    @property
    def row_channels(self) -> int:
        return self.level_dim + self.temporal_dim


@functools.lru_cache(maxsize=None)
def level_layout(cfg: HashGridConfig
                 ) -> Tuple[Tuple[int, ...], Tuple[float, ...], Tuple[int, ...]]:
    """(offsets, scales, resolutions) per level: ``scale`` =
    per_level_scale^l * base - 1, ``resolution`` = ceil(scale) + 1, rows =
    min(2^log2_hashmap_size, resolution^D) rounded up to a multiple of 8;
    ``offsets`` has one more entry, the table's rows."""
    offsets, scales, resolutions = [], [], []
    offset = 0
    max_params = 2**cfg.log2_hashmap_size
    for i in range(cfg.num_levels):
        scale = cfg.scale**i * cfg.base_resolution - 1.0
        resolution = int(np.ceil(scale)) + 1
        rows = min(max_params, resolution**cfg.input_dim)
        rows = int(np.ceil(rows / 8) * 8)
        offsets.append(offset)
        scales.append(scale)
        resolutions.append(resolution)
        offset += rows
    offsets.append(offset)
    return tuple(offsets), tuple(scales), tuple(resolutions)


def strided_levels(cfg: HashGridConfig) -> Tuple[bool, ...]:
    """Per level: indexed by strides (the dense grid fits, or ``tiled``)
    rather than hashed."""
    offsets, _, resolutions = level_layout(cfg)
    return tuple(
        cfg.gridtype == "tiled"
        or res**cfg.input_dim <= offsets[lvl + 1] - offsets[lvl]
        for lvl, res in enumerate(resolutions)
    )


def _check(cfg: HashGridConfig) -> None:
    if cfg.temporal_dim == 1 or cfg.temporal_dim < 0:
        raise ValueError(f"temporal_dim must be 0 or >= 2, got {cfg.temporal_dim}")
    if cfg.gridtype not in ("hash", "tiled") or cfg.hash_scheme not in ("xor", "zline"):
        raise ValueError(f"unknown gridtype/hash_scheme in {cfg}")


def init_hash_grid(cfg: HashGridConfig,
                   generator: Optional[torch.Generator] = None, device=None,
                   std: float = 1e-4) -> dict:
    """U(-std, std) embedding table."""
    _check(cfg)
    offsets, _, _ = level_layout(cfg)
    table = torch.rand((offsets[-1], cfg.row_channels), generator=generator)
    return {"embeddings": ((table * 2 - 1) * std).to(device)}


_level_constants: Dict[tuple, tuple] = {}


def _constants(cfg: HashGridConfig, device) -> tuple:
    """Per-level (scales f32, resolutions, rows, offsets: int64) as [L, 1,
    1] tensors on ``device``, made once per config and device."""
    key = (cfg, str(device))
    if key not in _level_constants:
        offsets, scales, resolutions = level_layout(cfg)
        rows = np.diff(np.asarray(offsets, np.int64))

        def col(a, dtype):
            return torch.tensor(a, dtype=dtype, device=device)[:, None, None]

        _level_constants[key] = (
            col(scales, torch.float32), col(resolutions, torch.int64),
            col(rows, torch.int64), col(offsets[:-1], torch.int64))
    return _level_constants[key]


def _outer(a: torch.Tensor, b: torch.Tensor, op) -> torch.Tensor:
    """[L, P, B], [L, Q, B] -> [L, P*Q, B]: ``op`` of every pair, the first
    operand's index the more significant."""
    out = op(a[:, :, None, :], b[:, None, :, :])
    return out.reshape(a.shape[0], -1, a.shape[-1])


def hash_index(coords, resolution, rows, cfg: HashGridConfig, strided: bool
               ) -> torch.Tensor:
    """Row indices of lattice corners given per dimension.

    Args:
        coords: D int64 tensors [L, n_d, B], dimension d's candidate
            coordinates (its two corner coordinates, or one); the result
            holds every combination.
        resolution, rows: int64 [L, 1, 1].
        strided: stride indexing (dense and tiled levels), else the hash
            of ``cfg.hash_scheme``.
    Returns:
        int64 [L, n_0 * ... * n_{D-1}, B] level-local rows in [0, rows)
        (zline: in (-rows, rows), negative where the last coordinate is),
        dimension 0's choice the most significant.
    """
    if strided:
        idx = coords[0]
        for c in coords[1:]:
            idx = _outer(idx * resolution, c, torch.add)
        return torch.remainder(idx, rows)
    if cfg.hash_scheme == "zline":
        # the leading dimensions hash with primes (d + 1) % 3, the last
        # adds: a cell's two z corners are neighbouring rows
        h = torch.zeros_like(coords[-1][:, :1])
        for d, c in enumerate(coords[:-1]):
            h = _outer(h, (c * _PRIMES[(d + 1) % 3]) & _MASK32, torch.bitwise_xor)
        # truncating, as lax.rem: a negative sum stays negative
        return torch.fmod(
            _outer(torch.remainder(h, rows), coords[-1], torch.add), rows)
    # uint32 products wrap: int64 products masked to 32 bits are the same
    h = coords[0] & _MASK32
    for d, c in enumerate(coords[1:], start=1):
        h = _outer(h, (c * _PRIMES[d % 3]) & _MASK32, torch.bitwise_xor)
    return torch.remainder(h, rows)


def grid_corners(cfg: HashGridConfig, xyz: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The lattice corners of every point on every level.

    ``pos = x * scale + 0.5`` (0 with ``align_corners``), corners
    ``floor(pos) + {0, 1}^D`` with no clamp: a corner outside the grid
    wraps through the modulo, and a negative zline row ``r`` of a level
    at ``offset`` is the table's row ``offset + r``, from the table's end
    when that is negative (the JAX package's CPU path's gather).

    Args:
        xyz: [B, D], in [0, 1] or (a deformed point) outside it.
    Returns:
        (idxs [L, 2^D, B] int32 rows of the whole table, ws [L, 2^D, B]
        f32 multilinear weights, differentiable w.r.t. ``xyz``); corner
        k's offset in dimension d is bit D-1-d of k.
    """
    _check(cfg)
    scales, resolutions, rows, offsets = _constants(cfg, xyz.device)
    strided = strided_levels(cfg)
    n_strided = sum(strided)
    if strided != (True,) * n_strided + (False,) * (len(strided) - n_strided):
        raise AssertionError("strided levels are expected to come first")

    pos = xyz.t()[None] * scales + (0.0 if cfg.align_corners else 0.5)  # [L, D, B]
    pos0 = torch.floor(pos)
    frac = pos - pos0
    base = pos0.detach().long()
    steps = torch.arange(2, device=xyz.device)[None, :, None]
    coords = [base[:, d:d + 1] + steps for d in range(cfg.input_dim)]   # [L, 2, B]

    parts = []
    if n_strided:
        parts.append(hash_index([c[:n_strided] for c in coords],
                                resolutions[:n_strided], rows[:n_strided], cfg,
                                True) + offsets[:n_strided])
    if n_strided < len(strided):
        hashed = hash_index([c[n_strided:] for c in coords],
                            resolutions[n_strided:], rows[n_strided:], cfg,
                            False) + offsets[n_strided:]
        if cfg.hash_scheme == "zline":
            # Python's indexing of a negative row: from the table's end
            hashed = torch.remainder(hashed, level_layout(cfg)[0][-1])
        parts.append(hashed)
    idxs = torch.cat(parts).to(torch.int32)

    ws = None
    for d in range(cfg.input_dim):
        f = frac[:, d:d + 1]
        wd = torch.cat([1.0 - f, f], dim=1)                              # [L, 2, B]
        ws = wd if ws is None else _outer(ws, wd, torch.mul)
    return idxs, ws


class _GatherSum(torch.autograd.Function):
    """``out[b, l*C:(l+1)*C] = sum_k ws[l, k, b] * table[idxs[l, k, b]]``."""

    @staticmethod
    def forward(ctx, table, idxs, ws):
        levels, corners, points = idxs.shape
        out = None
        for k in range(corners):
            term = ws[:, k, :, None] * torch.nn.functional.embedding(idxs[:, k], table)
            out = term if out is None else out + term
        ctx.save_for_backward(table, idxs, ws)
        return out.permute(1, 0, 2).reshape(points, -1)

    @staticmethod
    def backward(ctx, g):
        table, idxs, ws = ctx.saved_tensors
        levels, corners, points = idxs.shape
        g = g.contiguous()
        d_table = d_ws = None
        if ctx.needs_input_grad[0]:
            d_table = scatter_add_rows(g, idxs, ws.contiguous(),
                                       rows=table.shape[0])
        if ctx.needs_input_grad[2]:
            gl = g.view(points, levels, -1).permute(1, 0, 2)            # [L, B, C]
            d_ws = torch.stack([
                (gl * torch.nn.functional.embedding(idxs[:, k], table)).sum(-1)
                for k in range(corners)], dim=1)
        return d_table, None, d_ws


# ---------------------------------------------------------------------------
# temporal grids
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def temporal_tables(cfg: HashGridConfig):
    """The per-temporal-row channel tables, numpy (the JAX package's
    construction).  Consecutive temporal rows differ in one channel, so
    the window slides smoothly.  Returns:
      sampling_index [T-1, C*4] f32: per output channel (w_a, ch_a, w_b,
          ch_b), the channels as f32 (exact: they are < C + T);
      mask_a, mask_b [T-1, C*4] bool: where the time weights go;
      index_list [T-1, C+1] int64: [new_ch, next_ch, shared...], whose
          first two entries are the temporal TV loss's channel pair.
    """
    assert cfg.temporal_dim >= 2
    level_dim = cfg.level_dim
    index_init = [0, level_dim] + list(range(1, level_dim))
    permute_base = list(range(2, level_dim + 1))
    last_entry = 0
    index_list = [np.asarray(index_init, np.int64)]
    permute_list = [np.asarray([0] + permute_base, np.int64)]

    def to_sampling_index(index, permute, last_entry):
        row = index[permute]
        row = np.stack(
            [np.ones_like(row), row, np.zeros_like(row), np.zeros_like(row)], 1
        ).reshape(-1)
        mask_a = np.zeros_like(row, bool)
        mask_b = np.zeros_like(row, bool)
        row = row.astype(np.float32)
        row[last_entry * 4 + 3] = index[1]
        mask_a[last_entry * 4] = True
        mask_b[last_entry * 4 + 2] = True
        return row, mask_a, mask_b

    row, ma, mb = to_sampling_index(index_list[0], permute_list[0], last_entry)
    sampling_index, mask_a_list, mask_b_list = [row], [ma], [mb]
    for _ in range(1, cfg.temporal_dim - 1):
        last_entry += 1
        if last_entry >= level_dim:
            last_entry = 0
        last_max = int(index_list[-1].max())
        last_min = int(index_list[-1].min())
        tem_permute = permute_list[-1].copy()
        tem_permute[tem_permute == 0] += 1
        prev = index_list[-1][1:][tem_permute - 1].tolist()
        prev.pop(last_entry)
        new_index = np.asarray([last_min + 1, last_max + 1] + prev, np.int64)
        new_permute = np.asarray(
            permute_base[:last_entry] + [0] + permute_base[last_entry:], np.int64
        )
        index_list.append(new_index)
        permute_list.append(new_permute)
        row, ma, mb = to_sampling_index(new_index, new_permute, last_entry)
        sampling_index.append(row)
        mask_a_list.append(ma)
        mask_b_list.append(mb)

    return (np.stack(sampling_index), np.stack(mask_a_list),
            np.stack(mask_b_list), np.stack(index_list))


_temporal_constants: Dict[tuple, tuple] = {}


def _temporal_device_tables(cfg: HashGridConfig, device) -> tuple:
    """temporal_tables as tensors on ``device``, made once per config and
    device."""
    key = (cfg, str(device))
    if key not in _temporal_constants:
        _temporal_constants[key] = tuple(
            torch.from_numpy(a).to(device) for a in temporal_tables(cfg))
    return _temporal_constants[key]


def get_temporal_row(cfg: HashGridConfig, time: torch.Tensor) -> torch.Tensor:
    """time [B] in [0, 1] -> temporal-table row [B] int64:
    ``clip(floor(time * (T - 2)), 0, T - 2)``, in f32 as the JAX
    package's."""
    n_rows = cfg.temporal_dim - 1
    row_val = time.float() * (n_rows - 1)
    return torch.clamp(torch.floor(row_val).long(), 0, n_rows - 1)


def get_temporal_index(cfg: HashGridConfig, time: torch.Tensor) -> torch.Tensor:
    """time [B] in [0, 1] -> [B, C*4] rows (w_a, ch_a, w_b, ch_b) per output
    channel: the temporal row's picks, its time weights ``w_a = row + 1 -
    time * (T - 2)`` and ``w_b = time * (T - 2) - row`` where the masks put
    them (f32 arithmetic as the JAX package's)."""
    sampling_index, mask_a, mask_b, _ = _temporal_device_tables(cfg, time.device)
    n_rows = sampling_index.shape[0]
    row_val = time.float() * (n_rows - 1)
    row_idx = torch.clamp(torch.floor(row_val).long(), 0, n_rows - 1)
    w_a = (row_idx + 1 - row_val)[:, None]
    w_b = (row_val - row_idx)[:, None]
    rows = sampling_index[row_idx]
    rows = torch.where(mask_a[row_idx], w_a, rows)
    return torch.where(mask_b[row_idx], w_b, rows)


def _picked_entries(idx: torch.Tensor, ch: torch.Tensor, c_row: int, rows: int
                    ) -> torch.Tensor:
    """Flat indices ``idx * c_row + ch`` of the picked entries, int64.

    Args:
        idx: [..., B] int32 table rows; ch: [P, B] int64 picked channels.
    Returns:
        [..., P, B].  A row outside [0, rows) gives an index outside the
        flattened table (rows are clamped to [-1, rows] first, so that no
        product wraps into range when the caller casts to int32).
    """
    return idx.long().clamp(-1, rows).unsqueeze(-2) * c_row + ch


class _TemporalGatherSum(torch.autograd.Function):
    """``out[b, l*C + i] = sum_k ws[l, k, b] * sum_s w[b, i, s] *
    T[idxs[l, k, b], ch[b, i, s]]``: per point, level and corner the
    2 * C picked entries of the row; the corner sum comes first, then the
    time weights, as the JAX package's CPU path rounds it.

    The table gradient is one width-1 ``scatter_add_rows`` launch over the
    flattened table: one group per level, whose K * 2C "corners" are the
    (corner, picked entry) pairs, with the weights ``ws[l, k, b] * (g[b,
    l*C + i] * w[b, i, s])`` (the JAX transpose's products) and a gradient
    of ones.  The kernel's neighbouring lanes then take the picks of one
    corner's row together, so their reductions meet in the row's few
    32-byte sectors; a pick whose time weight is 0 (the second pick of
    every channel but the window's last) is pointed at its channel's first
    pick, adding 0 where the launch adds anyway.

    The corner weights' and the time weights' gradients (when autograd
    asks for them: positions or times that require grad) come from the
    picked entries gathered again in the backward, one corner at a time
    as the forward gathers them, rather than kept from the forward:
    ``d_ws[l, k, b] = sum_{i,s} g[b, l*C + i] w[b, i, s] T[idxs[l, k, b],
    ch[b, i, s]]`` and ``d_w[b, i, s] = sum_l g[b, l*C + i] acc[l, i, s,
    b]`` with ``acc`` the forward's corner sum, in plain PyTorch.
    """

    @staticmethod
    def forward(ctx, table, idxs, ws, ch, w):
        levels, corners, points = idxs.shape
        rows, c_row = table.shape
        flat_table = table.reshape(-1)
        picks = ch.reshape(points, -1).t().contiguous()                # [2C, B]
        acc = None
        for k in range(corners):
            vals = torch.take(flat_table,
                              _picked_entries(idxs[:, k], picks, c_row, rows))
            term = ws[:, k, None, :] * vals                            # [L, 2C, B]
            acc = term if acc is None else acc + term
        acc = acc.view(levels, -1, 2, points)                          # [L, C, 2, B]
        out = (acc * w.permute(1, 2, 0)[None]).sum(2)                  # [L, C, B]
        ctx.save_for_backward(table, idxs, ws, picks, w)
        return out.permute(2, 0, 1).reshape(points, -1)

    @staticmethod
    def backward(ctx, g):
        table, idxs, ws, picks, w = ctx.saved_tensors
        rows, c_row = table.shape
        levels, corners, points = idxs.shape
        n_picks = picks.shape[0]
        w = w.reshape(points, n_picks).t().contiguous()                # [2C, B]
        gl = g.reshape(points, levels, -1).permute(1, 2, 0)            # [L, C, B]
        gw = (gl[:, :, None] * w.view(-1, 2, points)).reshape(levels, n_picks,
                                                               points)
        d_ws = d_w = None
        if ctx.needs_input_grad[2] or ctx.needs_input_grad[4]:
            flat_table = table.reshape(-1)
            d_ws = torch.empty_like(ws)
            acc = None
            for k in range(corners):
                vals = torch.take(flat_table, _picked_entries(
                    idxs[:, k], picks, c_row, rows))                    # [L, 2C, B]
                d_ws[:, k] = (gw * vals).sum(1)
                term = ws[:, k, None, :] * vals
                acc = term if acc is None else acc + term
            d_w = (gl[:, :, None] * acc.view(levels, -1, 2, points)).sum(0)
            d_w = d_w.permute(2, 0, 1)                                 # [B, C, 2]
        first = picks.view(-1, 2, points)[:, :1].expand(-1, 2, -1)
        picks = torch.where(w == 0, first.reshape(n_picks, points), picks)
        flat = _picked_entries(idxs, picks, c_row, rows).to(torch.int32)
        d_table = scatter_add_rows(
            torch.ones((points, levels), device=g.device),
            flat.reshape(levels, -1, points),
            (ws[:, :, None] * gw[:, None]).reshape(levels, -1, points),
            rows=rows * c_row)
        return d_table.view(rows, c_row), None, d_ws, None, d_w


def hash_grid_encode(cfg: HashGridConfig, params: dict, xyz: torch.Tensor,
                     time: Optional[torch.Tensor] = None, *,
                     input_grads: bool = True) -> torch.Tensor:
    """Encode points (with time, for a temporal grid) -> [B, num_levels *
    level_dim].

    Args:
        params: {"embeddings": [rows, level_dim + temporal_dim] f32}.
        xyz: [B, input_dim] in [0, 1]; gradients reach it when it requires
            grad (through the corner weights).
        time: [B] in [0, 1], a temporal grid's only; gradients reach it
            when it requires grad (through the time weights).
        input_grads: False detaches ``xyz`` and ``time`` (the JAX
            package's flag: its fields pass ``not detached_inputs``).
    """
    if not input_grads:
        xyz = xyz.detach()
        time = None if time is None else time.detach()
    if cfg.temporal_dim == 0:
        if time is not None:
            raise ValueError("a static grid takes no time")
        idxs, ws = grid_corners(cfg, xyz)
        return _GatherSum.apply(params["embeddings"], idxs.contiguous(), ws)
    if time is None:
        raise ValueError("a temporal grid needs a time per point")
    idxs, ws = grid_corners(cfg, xyz)
    tri = get_temporal_index(cfg, time).view(xyz.shape[0], cfg.level_dim, 4)
    return _TemporalGatherSum.apply(params["embeddings"], idxs.contiguous(), ws,
                                    tri[..., 1::2].long(), tri[..., 0::2])


def temporal_tv_loss(cfg: HashGridConfig, params: dict, row) -> torch.Tensor:
    """Mean over the table's rows of ``|T[:, i0] - T[:, i1]|``, the channel
    pair ``(i0, i1)`` = the first two entries of ``index_list[row]``.

    The JAX package draws ``row`` with ``jax.random.randint`` from a key;
    torch cannot reproduce that stream, so the port takes the draw (an int
    or a 0-d int64 tensor in [0, T - 1), on the table's device: no host
    sync) from its caller.
    """
    table = params["embeddings"]
    index_list = _temporal_device_tables(cfg, table.device)[3]
    cols = table.index_select(1, index_list[row, :2])
    return torch.mean(torch.abs(cols[:, 0] - cols[:, 1]))
