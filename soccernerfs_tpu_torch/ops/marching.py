"""Isosurface extraction by marching tetrahedra, on the host in numpy
(counterpart of soccernerfs_tpu/ops/marching.py, whose numpy it copies):
each cube cell splits into 6 tetrahedra, each tetrahedron gives 0-2
triangles whose vertices are interpolated onto the level; vectorised over
the cells, duplicate vertices welded.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

# cube corner offsets (i, j, k)
_CORNERS = np.array(
    [
        [0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
        [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1],
    ]
)
# 6-tetrahedra decomposition of the cube (corner indices)
_TETS = np.array(
    [
        [0, 5, 1, 6],
        [0, 1, 2, 6],
        [0, 2, 3, 6],
        [0, 3, 7, 6],
        [0, 7, 4, 6],
        [0, 4, 5, 6],
    ]
)
# per-tet triangulation: for each of 16 inside-masks, edge pairs
# (a, b) index tet vertices; -1 padded.  Edges of a tet: (0,1),(0,2),
# (0,3),(1,2),(1,3),(2,3)
_TET_EDGES = np.array([[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]])
# triangle edge-index triples per inside-mask case (up to 2 triangles).
# one-inside / one-outside cases emit the triangle of that vertex's three
# edges; two-inside cases emit the crossing-edge quad as two triangles.
_CASES = {
    0b0000: [],
    0b0001: [(0, 1, 2)],
    0b0010: [(0, 3, 4)],
    0b0100: [(1, 3, 5)],
    0b1000: [(2, 4, 5)],
    0b0011: [(1, 3, 4), (1, 4, 2)],
    0b0101: [(0, 3, 5), (0, 5, 2)],
    0b0110: [(0, 1, 5), (0, 5, 4)],
    0b1001: [(0, 4, 5), (0, 5, 1)],
    0b1010: [(0, 2, 5), (0, 5, 3)],
    0b1100: [(1, 2, 4), (1, 4, 3)],
    0b0111: [(2, 4, 5)],
    0b1011: [(1, 3, 5)],
    0b1101: [(0, 3, 4)],
    0b1110: [(0, 1, 2)],
    0b1111: [],
}


def marching_tetrahedra(
    volume: np.ndarray, level: float, origin: np.ndarray, spacing: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Extract an isosurface mesh from a dense scalar volume.

    Args:
        volume: [X, Y, Z] scalar field.
        level: iso level.
        origin: [3] world position of voxel (0,0,0).
        spacing: [3] voxel size.
    Returns:
        (vertices [V, 3], faces [F, 3]).
    """
    X, Y, Z = volume.shape
    ii, jj, kk = np.meshgrid(
        np.arange(X - 1), np.arange(Y - 1), np.arange(Z - 1), indexing="ij"
    )
    cells = np.stack([ii, jj, kk], axis=-1).reshape(-1, 3)  # [C, 3]

    # corner values per cell [C, 8]
    corner_idx = cells[:, None, :] + _CORNERS[None, :, :]
    vals = volume[corner_idx[..., 0], corner_idx[..., 1], corner_idx[..., 2]]
    # cells crossing the level only
    crossing = (vals.min(axis=1) < level) & (vals.max(axis=1) > level)
    cells = cells[crossing]
    vals = vals[crossing]
    corner_idx = corner_idx[crossing]
    if cells.shape[0] == 0:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)

    corner_pos = origin[None, None, :] + corner_idx * spacing[None, None, :]

    verts_out = []
    for tet in _TETS:
        tvals = vals[:, tet]  # [C, 4]
        tpos = corner_pos[:, tet]  # [C, 4, 3]
        inside = tvals > level  # [C, 4]
        mask_code = (
            inside[:, 0].astype(int)
            | (inside[:, 1].astype(int) << 1)
            | (inside[:, 2].astype(int) << 2)
            | (inside[:, 3].astype(int) << 3)
        )
        for code in range(1, 15):
            tris = _CASES[code]
            if not tris:
                continue
            sel = mask_code == code
            if not sel.any():
                continue
            sv, sp = tvals[sel], tpos[sel]
            for tri in tris:
                tri_pts = []
                for edge_id in tri:
                    a, b = _TET_EDGES[edge_id]
                    va, vb = sv[:, a], sv[:, b]
                    denom = np.where(np.abs(vb - va) < 1e-12, 1e-12, vb - va)
                    t = np.clip((level - va) / denom, 0.0, 1.0)[:, None]
                    tri_pts.append(sp[:, a] * (1 - t) + sp[:, b] * t)
                verts_out.append(np.stack(tri_pts, axis=1))  # [S, 3, 3]

    if not verts_out:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)
    tris = np.concatenate(verts_out, axis=0)  # [T, 3, 3]
    verts = tris.reshape(-1, 3)
    faces = np.arange(verts.shape[0], dtype=np.int64).reshape(-1, 3)
    # weld duplicate vertices
    rounded = np.round(verts / (spacing.min() * 1e-4)).astype(np.int64)
    uniq, inverse = np.unique(rounded, axis=0, return_inverse=True)
    welded = np.zeros((uniq.shape[0], 3))
    np.add.at(welded, inverse, verts)
    counts = np.bincount(inverse)
    welded /= counts[:, None]
    return welded, inverse[faces.reshape(-1)].reshape(-1, 3)
