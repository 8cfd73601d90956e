"""Colormaps for rendered outputs, on host arrays (counterpart of
soccernerfs_tpu/utils/colormaps.py)."""
from __future__ import annotations

import numpy as np

# turbo colormap control points (8 anchors, linearly interpolated)
_TURBO_ANCHORS = np.array(
    [
        [0.190, 0.072, 0.232],
        [0.277, 0.370, 0.971],
        [0.110, 0.672, 0.845],
        [0.247, 0.919, 0.442],
        [0.724, 0.943, 0.222],
        [0.988, 0.652, 0.211],
        [0.885, 0.283, 0.096],
        [0.480, 0.016, 0.011],
    ]
)


def apply_colormap(values: np.ndarray, cmap: str = "turbo") -> np.ndarray:
    """Scalar [H, W] or [H, W, 1] values in [0, 1] -> [H, W, 3] colours of
    the turbo map."""
    v = np.asarray(values)
    if v.ndim == 3:
        v = v[..., 0]
    v = np.clip(v, 0.0, 1.0)
    x = v * (len(_TURBO_ANCHORS) - 1)
    lo = np.floor(x).astype(np.int32)
    hi = np.minimum(lo + 1, len(_TURBO_ANCHORS) - 1)
    t = (x - lo)[..., None]
    return _TURBO_ANCHORS[lo] * (1 - t) + _TURBO_ANCHORS[hi] * t


def apply_depth_colormap(
    depth: np.ndarray,
    accumulation: np.ndarray | None = None,
    near_plane: float | None = None,
    far_plane: float | None = None,
) -> np.ndarray:
    """Depth -> colour, scaled to [near, far] (the depth's min and max by
    default), blended toward white where ``accumulation`` is low."""
    d = np.asarray(depth, np.float32)
    if d.ndim == 3:
        d = d[..., 0]
    near = near_plane if near_plane is not None else float(np.min(d))
    far = far_plane if far_plane is not None else float(np.max(d))
    norm = np.clip((d - near) / max(far - near, 1e-10), 0, 1)
    colored = apply_colormap(norm)
    if accumulation is not None:
        acc = np.asarray(accumulation)
        if acc.ndim == 3:
            acc = acc[..., 0]
        colored = colored * acc[..., None] + (1 - acc[..., None])
    return colored
