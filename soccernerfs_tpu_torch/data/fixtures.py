"""Synthetic on-disk datasets for tests and smoke training (counterpart
of soccernerfs_tpu/data/fixtures.py: the same scenes, file names and
JSON, the same pixels), and the port's own HyperNeRF capture
(``make_hypernerf_fixture``), which the JAX package has no fixture for.
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


def _trace_ball_scene(h, w, pose, fx, fy, cx, cy, t: float):
    """Analytic render of a red ball moving along x over a green floor:
    the image [h, w, 3], each pixel ray's distance along its unit
    direction to the first hit (inf where it hits nothing) and the norm of
    its camera-frame direction (x, y, -1) [h, w]."""
    ys, xs = np.meshgrid(np.arange(h) + 0.5, np.arange(w) + 0.5, indexing="ij")
    dirs_cam = np.stack(
        [(xs - cx) / fx, -(ys - cy) / fy, -np.ones_like(xs)], axis=-1
    )
    R = pose[:3, :3]
    dirs = dirs_cam @ R.T
    norm = np.linalg.norm(dirs, axis=-1, keepdims=True)
    dirs /= norm
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
    dist = np.where(sphere_first, t_sphere, np.where(floor_vis, t_floor, np.inf))
    return img, dist, norm[..., 0]


def _render_ball_scene(h, w, pose, fx, fy, cx, cy, t: float) -> np.ndarray:
    """The ball scene's image (``_trace_ball_scene``)."""
    return _trace_ball_scene(h, w, pose, fx, fy, cx, cy, t)[0]


def make_broadcaststyle_fixture(
    root: Path,
    num_cameras: int = 4,
    num_steps: int = 4,
    h: int = 24,
    w: int = 32,
    downscale: int = 2,
    with_depth: bool = False,
) -> Path:
    """Write a tiny broadcaststyle-format dataset: ``Camera_{i}_{t:03d}.png``
    under ``images/{k}x/``, plus transforms.json with global intrinsics.
    ``with_depth`` also writes a depth map per image under
    ``depth-maps-mask/{k}x/`` (3 m everywhere at the parser's 0.01 unit,
    a 16-bit PNG: the bytes of Pillow's mode "I" PNG) and names it in each
    frame's ``depth_file_path``.

    Returns the dataset root (pass as ``--data``).
    """
    root = Path(root)
    img_dir = root / "images" / f"{downscale}x"
    img_dir.mkdir(parents=True, exist_ok=True)
    if with_depth:
        depth_dir = root / "depth-maps-mask" / f"{downscale}x"
        depth_dir.mkdir(parents=True, exist_ok=True)

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
            if with_depth:
                Image.fromarray(np.full((h, w), 300, np.uint16)).save(
                    depth_dir / name)
                frame["depth_file_path"] = f"depth-maps/{name}"
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


def make_nerfstudio_fixture(root: Path, num_frames: int = 20, h: int = 24,
                            w: int = 32, downscale: int = 1) -> Path:
    """A static nerfstudio-format scene: ``num_frames`` cameras on a ring
    around the ball scene (the ball at rest in its middle, over the
    floor), looking at it from a little above, so that the top of each
    image sees no floor; ``transforms.json`` with global intrinsics (of
    the full-size images, ``downscale`` times h x w), ``images/`` and
    ``depths/`` at full size or, for ``downscale`` > 1, ``images_{k}/``
    and ``depths_{k}/`` at h x w.  Depths are 16-bit PNGs of each pixel's
    z-depth (along the camera's axis) in millimetres
    (``depth_unit_scale_factor`` 1e-3), 0 where its ray hits nothing.

    Returns the dataset root (pass as ``--data``)."""
    root = Path(root)
    suffix = f"_{downscale}" if downscale > 1 else ""
    img_dir, depth_dir = root / f"images{suffix}", root / f"depths{suffix}"
    img_dir.mkdir(parents=True, exist_ok=True)
    depth_dir.mkdir(parents=True, exist_ok=True)
    fx = fy = 0.7 * w * downscale
    cx, cy = w * downscale / 2.0, h * downscale / 2.0
    frames = []
    for i in range(num_frames):
        theta = 2 * np.pi * i / num_frames
        pose = _look_at_pose([2.5 * np.cos(theta), 2.5 * np.sin(theta), 0.5])
        img, dist, norm = _trace_ball_scene(
            h, w, pose, fx / downscale, fy / downscale, cx / downscale,
            cy / downscale, 0.5)
        depth_mm = np.where(np.isfinite(dist), np.round(dist / norm * 1e3), 0)
        name = f"frame_{i:05d}.png"
        Image.fromarray((img * 255).astype(np.uint8)).save(img_dir / name)
        Image.fromarray(depth_mm.astype(np.uint16)).save(depth_dir / name)
        frames.append({"file_path": f"images/{name}",
                       "depth_file_path": f"depths/{name}",
                       "transform_matrix": pose.tolist()})
    meta = {"fl_x": fx, "fl_y": fy, "cx": cx, "cy": cy, "w": w * downscale,
            "h": h * downscale, "camera_model": "OPENCV", "k1": 0.0,
            "k2": 0.0, "p1": 0.0, "p2": 0.0, "frames": frames}
    with open(root / "transforms.json", "w") as f:
        json.dump(meta, f)
    return root


def make_sitcoms3d_fixture(root: Path, num_cameras: int = 4, h: int = 24,
                           w: int = 32, downscale: int = 4) -> Path:
    """A Sitcoms3D-format scene for semantic-nerfw: ``cameras.json`` with
    per-frame intrinsics (of the full-size images, ``downscale`` times
    h x w) and camtoworld and the scene bbox, ``images_{d}/`` JPEGs of the
    ball scene at rest from a ring of cameras, ``segmentations_{d}/thing/``
    label PNGs (0 background, 1 ball, 2 floor) and
    ``panoptic_classes.json``.  Poses and bbox are written rotated by the
    inverse of the parser's z-up rotation, so that the parsed scene is the
    ball scene."""
    root = Path(root)
    img_dir = root / f"images_{downscale}"
    seg_dir = root / f"segmentations_{downscale}" / "thing"
    img_dir.mkdir(parents=True, exist_ok=True)
    seg_dir.mkdir(parents=True, exist_ok=True)
    rot = np.array([[1, 0, 0], [0, 0, -1], [0, 1, 0]], np.float64)
    fx = fy = 0.7 * w * downscale
    cx, cy = w * downscale / 2.0, h * downscale / 2.0
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float64)
    frames = []
    for ci in range(num_cameras):
        theta = 2 * np.pi * ci / num_cameras
        pose = _look_at_pose([2.2 * np.cos(theta), 2.2 * np.sin(theta), 1.0])
        name = f"frame_{ci:04d}.jpg"
        img = _render_ball_scene(h, w, pose, fx / downscale, fy / downscale,
                                 cx / downscale, cy / downscale, 0.0)
        Image.fromarray((img * 255).astype(np.uint8)).save(img_dir / name)
        # the floor first, so that a ball pixel keeps its label
        labels = np.zeros((h, w), np.uint8)
        labels[img[..., 1] > 0.5] = 2
        labels[img[..., 0] > 0.5] = 1
        Image.fromarray(labels).save(seg_dir / name.replace(".jpg", ".png"))
        c2w_file = np.concatenate([rot.T @ pose[:3, :4], [[0.0, 0.0, 0.0, 1.0]]],
                                  axis=0)
        frames.append({"image_name": name, "intrinsics": K.tolist(),
                       "camtoworld": c2w_file.tolist()})
    bbox = np.array([[-1.5, -1.5, -0.2], [1.5, 1.5, 1.5]], np.float64)
    with open(root / "cameras.json", "w") as f:
        json.dump({"frames": frames, "bbox": (bbox @ rot).tolist()}, f)
    with open(root / "panoptic_classes.json", "w") as f:
        json.dump({"thing": ["class_0", "class_1", "class_2"],
                   "thing_colors": (np.eye(3) * 255).astype(int).tolist()}, f)
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


def _hypernerf_camera_json(c2w: np.ndarray, center, scale: float,
                          focal: float, principal_point, image_size,
                          radial, tangential) -> dict:
    """The nerfies camera file whose pose the HyperNeRF parser reads back as
    ``c2w`` (3 x 4, in the parser's output frame): the inverse of its axis
    flips, recentring and scaling."""
    final = np.asarray(c2w, np.float64)[:3]
    # the parser's rows are (pose0[0], -pose0[2], pose0[1])
    pose0 = np.stack([final[0], final[2], -final[1]])
    flips = np.array([[1, -1, -1], [-1, 1, 1], [-1, 1, 1]], np.float64)
    orientation = (pose0[:, :3] * flips).T
    position = pose0[:, 3] * np.array([1, -1, -1]) / scale + np.asarray(center)
    return {"orientation": orientation.tolist(), "position": position.tolist(),
            "focal_length": focal, "principal_point": list(principal_point),
            "image_size": list(image_size), "skew": 0.0, "pixel_aspect_ratio": 1.0,
            "radial_distortion": list(radial),
            "tangential_distortion": list(tangential)}


def make_hypernerf_fixture(root: Path, num_times: int = 6, h: int = 24,
                           w: int = 32, downscale: int = 2, seed: int = 0
                           ) -> Path:
    """A HyperNeRF (nerfies) capture of the ball scene: two cameras, "left"
    and "right" (0.3 apart), moving along an arc around the moving ball
    over ``num_times`` steps; ``scene.json`` (a center and scale that the
    parser undoes), ``camera/{side}_{t:05d}.json`` at the full size
    (``downscale`` times h x w) with small nonzero radial and tangential
    distortions drawn from ``seed``, and ``rgb/{downscale}x/{side}_{t:05d}.png``
    at h x w, rendered as pinhole images with the poses the parser returns.
    The ball is at time t / (num_times - 1).

    Returns the dataset root (pass as ``--data``)."""
    root = Path(root)
    rng = np.random.default_rng(seed)
    img_dir = root / "rgb" / f"{downscale}x"
    img_dir.mkdir(parents=True, exist_ok=True)
    (root / "camera").mkdir(parents=True, exist_ok=True)
    center, scale = [0.1, -0.2, 0.05], 0.8
    with open(root / "scene.json", "w") as f:
        json.dump({"center": center, "scale": scale, "near": 0.05, "far": 10.0}, f)
    focal = 0.8 * w * downscale
    pp = (w * downscale / 2.0, h * downscale / 2.0)
    for t in range(num_times):
        theta = 0.6 * t / max(num_times - 1, 1) - 0.3
        for side, offset in (("left", -0.15), ("right", 0.15)):
            origin = np.array([2.5 * np.cos(theta) + offset * np.sin(theta),
                               2.5 * np.sin(theta) - offset * np.cos(theta), 0.8])
            pose = _look_at_pose(origin)
            radial = rng.uniform(-0.02, 0.02, 3) * np.array([1.0, 0.5, 0.1])
            tangential = rng.uniform(-0.002, 0.002, 2)
            name = f"{side}_{t:05d}"
            with open(root / "camera" / f"{name}.json", "w") as f:
                json.dump(_hypernerf_camera_json(
                    pose[:3], center, scale, focal, pp,
                    (w * downscale, h * downscale), radial, tangential), f)
            img = _render_ball_scene(h, w, pose, focal / downscale,
                                     focal / downscale, pp[0] / downscale,
                                     pp[1] / downscale,
                                     t / max(num_times - 1, 1))
            Image.fromarray((img * 255).astype(np.uint8)).save(img_dir / f"{name}.png")
    return root
