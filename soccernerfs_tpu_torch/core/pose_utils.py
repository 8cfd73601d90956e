"""Pose utilities (counterpart of soccernerfs_tpu/core/pose_utils.py; host
numpy, the same functions).

Dataparsers run these once on the host at startup; only ray generation
runs on the device.
"""
from __future__ import annotations

import numpy as np


def to4x4(pose: np.ndarray) -> np.ndarray:
    """[..., 3, 4] -> [..., 4, 4] homogeneous (ref: utils/poses.py:22-33)."""
    constants = np.zeros_like(pose[..., :1, :])
    constants[..., 0, 3] = 1.0
    return np.concatenate([pose, constants], axis=-2)


def multiply(pose_a: np.ndarray, pose_b: np.ndarray) -> np.ndarray:
    """Compose two [R|t] transforms: a @ b (ref: utils/poses.py:36-49)."""
    R1, t1 = pose_a[..., :3, :3], pose_a[..., :3, 3:]
    R2, t2 = pose_b[..., :3, :3], pose_b[..., :3, 3:]
    R = R1 @ R2
    t = R1 @ t2 + t1
    return np.concatenate([R, t], axis=-1)


def inverse(pose: np.ndarray) -> np.ndarray:
    """Invert an [R|t] transform (ref: utils/poses.py:52-63)."""
    R = pose[..., :3, :3]
    t = pose[..., :3, 3:]
    R_inv = np.swapaxes(R, -1, -2)
    return np.concatenate([R_inv, -R_inv @ t], axis=-1)


def normalize(v: np.ndarray) -> np.ndarray:
    return v / np.linalg.norm(v)


def rotation_matrix_between(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Rotation taking unit vector a to unit vector b
    (ref: camera_utils.py:415-438, Rodrigues form)."""
    a, b = normalize(a), normalize(b)
    v = np.cross(a, b)
    c = float(np.dot(a, b))
    if np.linalg.norm(v) < 1e-10:
        return np.eye(3) if c > 0 else -np.eye(3)
    skew = np.array(
        [[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]], dtype=a.dtype
    )
    return np.eye(3) + skew + skew @ skew * (1.0 / (1.0 + c))


def focus_of_attention(poses: np.ndarray, initial_focus: np.ndarray) -> np.ndarray:
    """Point closest to all camera optical axes, iteratively filtered to
    cameras that face it (ref: camera_utils.py:440-467)."""
    active_directions = -poses[:, :3, 2:3]
    active_origins = poses[:, :3, 3:4]
    focus_pt = initial_focus
    active = (
        np.sum(active_directions.squeeze(-1) * (focus_pt - active_origins.squeeze(-1)), axis=-1)
        > 0
    )
    done = False
    while np.sum(active) > 1 and not done:
        active_directions_a = active_directions[active]
        active_origins_a = active_origins[active]
        m = np.eye(3) - active_directions_a * np.swapaxes(active_directions_a, -1, -2)
        mt_m = np.swapaxes(m, -1, -2) @ m
        focus_pt = np.linalg.inv(mt_m.mean(axis=0)) @ (mt_m @ active_origins_a).mean(axis=0)
        focus_pt = focus_pt.squeeze(-1)
        new_active = (
            np.sum(
                active_directions.squeeze(-1) * (focus_pt - active_origins.squeeze(-1)),
                axis=-1,
            )
            > 0
        )
        if np.array_equal(new_active, active):
            done = True
        active = new_active
    return focus_pt


def auto_orient_and_center_poses(
    poses: np.ndarray,
    method: str = "up",
    center_method: str = "poses",
):
    """Orient and center camera poses (ref: camera_utils.py:470-575).

    Args:
        poses: [N, 4, 4] camera-to-world.
        method: "pca" | "up" | "vertical" | "none".
        center_method: "poses" | "focus" | "none".
    Returns:
        (oriented_poses [N, 3, 4], transform [3, 4]) — transform maps
        original world coords into the oriented frame.
    """
    origins = poses[..., :3, 3]
    mean_origin = origins.mean(axis=0)
    translation_diff = origins - mean_origin

    if center_method == "poses":
        translation = mean_origin
    elif center_method == "focus":
        translation = focus_of_attention(poses, mean_origin)
    elif center_method == "none":
        translation = np.zeros_like(mean_origin)
    else:
        raise ValueError(f"unknown center_method {center_method}")

    if method == "pca":
        _, eigvec = np.linalg.eigh(translation_diff.T @ translation_diff)
        eigvec = np.flip(eigvec, axis=-1).copy()
        if np.linalg.det(eigvec) < 0:
            eigvec[:, 2] = -eigvec[:, 2]
        transform = np.concatenate([eigvec, eigvec @ -translation[..., None]], axis=-1)
        oriented_poses = transform @ poses
        if oriented_poses.mean(axis=0)[2, 1] < 0:
            oriented_poses[:, 1:3] = -oriented_poses[:, 1:3]
    elif method in ("up", "vertical"):
        up = poses[:, :3, 1].mean(axis=0)
        up = normalize(up)
        if method == "vertical":
            x_axis_matrix = poses[:, :3, 0]
            _, S, Vh = np.linalg.svd(x_axis_matrix, full_matrices=False)
            if S[1] > 0.17 * np.sqrt(poses.shape[0]):
                # non-degenerate: least-vertical singular vector, sign toward up
                up_vertical = Vh[2, :]
                up = up_vertical if np.dot(up_vertical, up) > 0 else -up_vertical
            else:
                # degenerate config: project up onto the span of the two
                # best right-singular vectors
                up = Vh[:2, :].T @ (Vh[:2, :] @ up[..., None])
                up = normalize(up.squeeze(-1))
        rotation = rotation_matrix_between(up, np.array([0.0, 0.0, 1.0]))
        transform = np.concatenate([rotation, rotation @ -translation[..., None]], axis=-1)
        oriented_poses = transform @ poses
    elif method == "none":
        transform = np.eye(4)[:3]
        transform[:, 3] = -translation
        oriented_poses = transform @ poses
    else:
        raise ValueError(f"unknown orientation method {method}")

    return oriented_poses[..., :3, :4], transform
