"""Multi-level hash-grid encoder, static grids (counterpart of
soccernerfs_tpu/ops/hash_grid.py with ``temporal_dim == 0``).

One flat ``[rows, level_dim]`` table holds every level at an offset.  A
level whose dense grid fits its share of the table (and every level of a
``tiled`` grid) is indexed by strides; the others hash the lattice corner:
``xor`` is the torch-ngp prime-XOR hash, ``zline`` hashes the leading
dimensions and adds the last one.  The row indices are those of the JAX
package bit for bit (a snapshot's table is only meaningful under its
hash), for lattice coordinates >= 0, which is what inputs in [0, 1] give;
negative coordinates wrap through the modulo to rows in range, but not to
the JAX package's rows.

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

    temporal_dim: int = 0  # 0: a static grid, the only kind ported
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
    if cfg.temporal_dim > 0:
        raise NotImplementedError("temporal hash grids are not ported yet")
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
        int64 [L, n_0 * ... * n_{D-1}, B] level-local rows in [0, rows),
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
        return torch.remainder(
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
    wraps through the modulo.

    Args:
        xyz: [B, D] in [0, 1].
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
                                resolutions[:n_strided], rows[:n_strided], cfg, True))
    if n_strided < len(strided):
        parts.append(hash_index([c[n_strided:] for c in coords],
                                resolutions[n_strided:], rows[n_strided:], cfg, False))
    idxs = (torch.cat(parts) + offsets).to(torch.int32)

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


def hash_grid_encode(cfg: HashGridConfig, params: dict, xyz: torch.Tensor
                     ) -> torch.Tensor:
    """Encode points -> [B, num_levels * level_dim].

    Args:
        params: {"embeddings": [rows, level_dim] f32}.
        xyz: [B, input_dim] in [0, 1]; gradients reach it when it requires
            grad (through the corner weights).
    """
    idxs, ws = grid_corners(cfg, xyz)
    return _GatherSum.apply(params["embeddings"], idxs.contiguous(), ws)
