"""Synthetic on-disk datasets for tests and smoke training (counterpart
of soccernerfs_tpu/data/fixtures.py: the same scenes, file names and
JSON, the same pixels).
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
from PIL import Image


def _look_at_pose(origin, target=(0.0, 0.0, 0.0), up=(0.0, 0.0, 1.0)) -> np.ndarray:
    """OpenGL-style c2w (camera looks down -Z)."""
    origin = np.asarray(origin, np.float64)
    forward = np.asarray(target, np.float64) - origin
    forward /= np.linalg.norm(forward)
    right = np.cross(forward, np.asarray(up, np.float64))
    right /= np.linalg.norm(right)
    true_up = np.cross(right, forward)
    pose = np.eye(4)
    pose[:3, 0] = right
    pose[:3, 1] = true_up
    pose[:3, 2] = -forward
    pose[:3, 3] = origin
    return pose


def _render_ball_scene(h, w, pose, fx, fy, cx, cy, t: float) -> np.ndarray:
    """Analytic render: red ball moving along x over a green floor."""
    ys, xs = np.meshgrid(np.arange(h) + 0.5, np.arange(w) + 0.5, indexing="ij")
    dirs_cam = np.stack(
        [(xs - cx) / fx, -(ys - cy) / fy, -np.ones_like(xs)], axis=-1
    )
    R = pose[:3, :3]
    dirs = dirs_cam @ R.T
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    origin = pose[:3, 3]

    center = np.array([0.6 * (t - 0.5), 0.0, 0.15])
    oc = origin - center
    b = np.sum(dirs * oc, axis=-1)
    c = np.sum(oc * oc) - 0.15**2
    disc = b * b - c
    hit_sphere = disc > 0
    t_sphere = np.where(hit_sphere, -b - np.sqrt(np.maximum(disc, 0)), np.inf)

    t_floor = np.where(dirs[..., 2] < -1e-6, (0.0 - origin[2]) / dirs[..., 2], np.inf)

    img = np.zeros((h, w, 3), np.float32)
    sphere_first = hit_sphere & (t_sphere < t_floor) & (t_sphere > 0)
    floor_vis = (t_floor < np.inf) & ~sphere_first & (t_floor > 0)
    img[sphere_first] = [0.9, 0.15, 0.1]
    img[floor_vis] = [0.1, 0.7, 0.2]
    return img


def make_broadcaststyle_fixture(
    root: Path,
    num_cameras: int = 4,
    num_steps: int = 4,
    h: int = 24,
    w: int = 32,
    downscale: int = 2,
) -> Path:
    """Write a tiny broadcaststyle-format dataset: ``Camera_{i}_{t:03d}.png``
    under ``images/{k}x/``, plus transforms.json with global intrinsics.

    Returns the dataset root (pass as ``--data``).
    """
    root = Path(root)
    img_dir = root / "images" / f"{downscale}x"
    img_dir.mkdir(parents=True, exist_ok=True)

    fx = fy = 0.7 * w * downscale
    cx, cy = w * downscale / 2.0, h * downscale / 2.0

    # train cameras Camera_1..{n-1} plus the "all"-setup eval camera Camera_20
    cam_names = [f"Camera_{i + 1}" for i in range(num_cameras - 1)] + ["Camera_20"]
    frames = []
    for ci, cam_name in enumerate(cam_names):
        theta = 2 * np.pi * ci / num_cameras
        origin = [2.2 * np.cos(theta), 2.2 * np.sin(theta), 1.0]
        pose = _look_at_pose(origin)
        for t in range(num_steps):
            name = f"{cam_name}_{t:03d}.png"
            tt = t / max(num_steps - 1, 1)
            img = _render_ball_scene(
                h, w, pose, fx / downscale, fy / downscale, cx / downscale, cy / downscale, tt
            )
            Image.fromarray((img * 255).astype(np.uint8)).save(img_dir / name)
            frame = {
                "file_path": f"images/{name}",
                "transform_matrix": pose.tolist(),
            }
            frames.append(frame)

    meta = {
        "fl_x": fx,
        "fl_y": fy,
        "cx": cx,
        "cy": cy,
        "w": w * downscale,
        "h": h * downscale,
        "camera_model": "OPENCV",
        "k1": 0.0,
        "k2": 0.0,
        "p1": 0.0,
        "p2": 0.0,
        "frames": frames,
    }
    with open(root / "transforms.json", "w") as f:
        json.dump(meta, f)
    return root


def make_blender_fixture(
    root: Path, num_frames: int = 3, h: int = 20, w: int = 20,
    with_times: bool = False,
) -> Path:
    """Blender-synthetic fixture: transforms_{train,val,test}.json + pngs
    (mirrors the reference's tests/data/lego_test).

    ``with_times=True`` writes the D-NeRF variant: a per-frame ``time``
    field and a time-dependent ball position, so the time-conditioned
    path (dnerf) is actually exercised (ref: dnerf_dataparser.py:36-48).
    """
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    camera_angle_x = 0.8
    for split in ("train", "val", "test"):
        split_dir = root / split
        split_dir.mkdir(exist_ok=True)
        frames = []
        for i in range(num_frames):
            theta = 2 * np.pi * i / num_frames + (0.3 if split != "train" else 0.0)
            t = i / max(num_frames - 1, 1) if with_times else 0.0
            pose = _look_at_pose([2 * np.cos(theta), 2 * np.sin(theta), 1.2])
            fx = 0.5 * w / np.tan(0.5 * camera_angle_x)
            img = _render_ball_scene(h, w, pose, fx, fx, w / 2, h / 2, t)
            rgba = np.concatenate([img, np.ones((h, w, 1), np.float32)], axis=-1)
            Image.fromarray((rgba * 255).astype(np.uint8), mode="RGBA").save(
                split_dir / f"r_{i}.png")
            frame = {
                "file_path": f"./{split}/r_{i}", "transform_matrix": pose.tolist()
            }
            if with_times:
                frame["time"] = t
            frames.append(frame)
        with open(root / f"transforms_{split}.json", "w") as f:
            json.dump({"camera_angle_x": camera_angle_x, "frames": frames}, f)
    return root
