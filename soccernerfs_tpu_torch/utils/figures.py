"""Scene figures and paper-figure helpers (counterpart of
soccernerfs_tpu/utils/figures.py).

Camera frustums as numpy geometry, a headless matplotlib 3-D figure of a
dataset's cameras and sampled rays (``vis_dataset``), the turbo colour
map, and the strip split and crop panels of ``scripts/figures.py``.  The
port's ``Cameras`` hold tensors; the geometry reads them on the host.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


def _host(x) -> np.ndarray:
    """A tensor or array as a numpy array on the host."""
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def frustum_corners(
    c2w: np.ndarray,
    fx: float,
    fy: float,
    cx: float,
    cy: float,
    width: int,
    height: int,
    depth: float = 0.3,
) -> np.ndarray:
    """World-space corners of one camera frustum at the given depth.

    Conventions match core.cameras.generate_rays (OpenGL-style: x right,
    y up, camera looks along -z; ref camera model
    nerfstudio/cameras/cameras.py).

    Args:
        c2w: [3, 4] camera-to-world.
        depth: frustum depth along the view axis.
    Returns:
        [5, 3] points: apex then the 4 image corners (tl, tr, br, bl).
    """
    c2w = np.asarray(c2w, np.float32)
    corners_px = np.array(
        [[0.0, 0.0], [width, 0.0], [width, height], [0.0, height]],
        np.float32,
    )
    x = (corners_px[:, 0] - cx) / fx
    y = -(corners_px[:, 1] - cy) / fy
    dirs_cam = np.stack([x, y, -np.ones(4, np.float32)], -1) * depth
    pts = c2w[:, 3] + dirs_cam @ c2w[:, :3].T
    return np.concatenate([c2w[None, :, 3], pts], axis=0)


def frustum_segments(corners: np.ndarray) -> np.ndarray:
    """[5, 3] frustum corners -> [8, 2, 3] line segments (4 edges from the
    apex + the image-plane rectangle)."""
    apex, quad = corners[0], corners[1:]
    segs = [np.stack([apex, q]) for q in quad]
    segs += [np.stack([quad[i], quad[(i + 1) % 4]]) for i in range(4)]
    return np.stack(segs)


def camera_frustum_segments(cameras, depth: float = 0.3) -> np.ndarray:
    """All cameras' frustum segments: [N*8, 2, 3] (ref: plotly_utils.py:549
    get_camera_frustums)."""
    c2w, fx, fy, cx, cy, w, h = (
        _host(getattr(cameras, f)) for f in ("camera_to_worlds", "fx", "fy",
                                              "cx", "cy", "width", "height"))
    segs = [
        frustum_segments(
            frustum_corners(
                c2w[i], float(fx[i]), float(fy[i]), float(cx[i]),
                float(cy[i]), int(w[i]), int(h[i]), depth,
            )
        )
        for i in range(c2w.shape[0])
    ]
    return np.concatenate(segs, axis=0)


def vis_dataset(
    cameras,
    ray_origins: Optional[np.ndarray] = None,
    ray_directions: Optional[np.ndarray] = None,
    ray_length: float = 2.0,
    max_rays: int = 500,
    save_path: Optional[str] = None,
    frustum_depth: float = 0.3,
):
    """3D figure of the dataset's cameras (+ optional sampled rays).

    Matplotlib equivalent of the reference's plotly vis_dataset
    (ref: plotly_utils.py:102-147): camera origins as markers, frustum
    wireframes, and ray segments of the given length.

    Args:
        cameras: core.cameras.Cameras, on any device.
        ray_origins/ray_directions: optional [M, 3] sampled rays.
        save_path: if given, saves the figure (headless-safe) and
            returns the path; otherwise returns the matplotlib figure.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from mpl_toolkits.mplot3d.art3d import Line3DCollection

    fig = plt.figure(figsize=(10, 10))
    ax = fig.add_subplot(projection="3d")
    origins = _host(cameras.camera_to_worlds)[:, :, 3]
    ax.scatter(origins[:, 0], origins[:, 1], origins[:, 2],
               c="k", s=25, label="camera origins")
    segs = camera_frustum_segments(cameras, depth=frustum_depth)
    ax.add_collection3d(
        Line3DCollection(segs, colors="tab:blue", linewidths=0.7)
    )
    if ray_origins is not None and ray_directions is not None:
        o = _host(ray_origins)[:max_rays]
        d = _host(ray_directions)[:max_rays]
        rays = np.stack([o, o + d * ray_length], axis=1)
        ax.add_collection3d(
            Line3DCollection(rays, colors="tab:orange", linewidths=0.4)
        )
    lo = origins.min(0) - ray_length
    hi = origins.max(0) + ray_length
    ax.set_xlim(lo[0], hi[0])
    ax.set_ylim(lo[1], hi[1])
    ax.set_zlim(lo[2], hi[2])
    ax.set_box_aspect((1, 1, 1))
    ax.legend()
    if save_path is not None:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return save_path
    return fig


def turbo_colormap(gray: np.ndarray) -> np.ndarray:
    """Grayscale [H, W] (or [H, W, 1]) in [0, 1] -> turbo RGB uint8
    (ref: scripts/figures/turbo.py)."""
    from matplotlib import cm

    g = np.asarray(gray, np.float32)
    if g.ndim == 3:
        g = g[..., 0]
    g = np.clip(g, 0.0, 1.0)
    return (cm.turbo(g)[..., :3] * 255).astype(np.uint8)


def split_strip(
    img: np.ndarray, n: int
) -> Tuple[np.ndarray, ...]:
    """Split a horizontally concatenated {GT|Pred1|...|PredN-1} strip into
    its N equal-width panels (ref: scripts/figures/splitpics.py)."""
    w = img.shape[1]
    assert w % n == 0, f"strip width {w} not divisible by {n}"
    pw = w // n
    return tuple(img[:, i * pw:(i + 1) * pw] for i in range(n))


def crop_panels(
    gt: np.ndarray,
    preds: Sequence[np.ndarray],
    rect: Tuple[int, int, int, int],
    border: int = 3,
    color: Tuple[int, int, int] = (255, 0, 0),
):
    """GT with the crop rectangle drawn + the rectangle extracted from GT
    and every prediction (ref: scripts/figures/croppics.py — the pygame
    click-UI replaced by an explicit ``rect``; headless).

    Args:
        rect: (x, y, w, h) in pixels.
    Returns:
        (gt_marked, [crop_gt, crop_pred1, ...]) uint8 arrays.
    """
    x, y, w, h = rect
    gt = np.asarray(gt)
    marked = gt.copy()
    c = np.array(color, dtype=marked.dtype)
    marked[y:y + border, x:x + w] = c
    marked[y + h - border:y + h, x:x + w] = c
    marked[y:y + h, x:x + border] = c
    marked[y:y + h, x + w - border:x + w] = c
    crops = [np.asarray(im)[y:y + h, x:x + w] for im in (gt, *preds)]
    return marked, crops
