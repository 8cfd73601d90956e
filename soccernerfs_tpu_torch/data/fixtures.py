"""Synthetic on-disk datasets for tests and smoke training (counterpart
of soccernerfs_tpu/data/fixtures.py: the same scenes, file names and
JSON, the same pixels), and the port's own captures of the ball scene in
the formats the JAX package has no fixture for: HyperNeRF, a COLMAP
model, instant-ngp, the minimal npz, phototourism, dycheck, sdfstudio,
ScanNet and ARKitScenes.  Each draws what it varies from ``seed``.
"""
from __future__ import annotations

import json
import struct
from pathlib import Path

import numpy as np
from PIL import Image

from soccernerfs_tpu_torch.data.colmap_utils import CAMERA_MODEL_IDS


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


def _undistort(xd, yd, distortion, iterations: int = 20):
    """Normalised image coordinates whose OpenCV radial-tangential
    distortion by (k1, k2, k3, k4, p1, p2) is (xd, yd), by fixed-point
    iteration (small distortions)."""
    k1, k2, k3, k4, p1, p2 = (float(v) for v in distortion)
    x, y = xd, yd
    for _ in range(iterations):
        r = x * x + y * y
        d = 1.0 + r * (k1 + r * (k2 + r * (k3 + r * k4)))
        x = (xd - 2 * p1 * x * y - p2 * (r + 2 * x * x)) / d
        y = (yd - 2 * p2 * x * y - p1 * (r + 2 * y * y)) / d
    return x, y


def _trace_ball_scene(h, w, pose, fx, fy, cx, cy, t: float, distortion=None):
    """Analytic render of a red ball moving along x over a green floor:
    the image [h, w, 3], each pixel ray's distance along its unit
    direction to the first hit (inf where it hits nothing) and the norm of
    its camera-frame direction (x, y, -1) [h, w].  ``distortion`` (k1, k2,
    k3, k4, p1, p2) renders the camera that ``core.cameras`` models with
    it: each pixel's y-up normalised coordinates, undistorted."""
    ys, xs = np.meshgrid(np.arange(h) + 0.5, np.arange(w) + 0.5, indexing="ij")
    dirs_cam = np.stack(
        [(xs - cx) / fx, -(ys - cy) / fy, -np.ones_like(xs)], axis=-1
    )
    if distortion is not None:
        dirs_cam[..., 0], dirs_cam[..., 1] = _undistort(
            dirs_cam[..., 0], dirs_cam[..., 1], distortion)
    R = pose[:3, :3]
    dirs = dirs_cam @ R.T
    norm = np.linalg.norm(dirs, axis=-1, keepdims=True)
    dirs /= norm
    img, dist = _hit_ball_scene(pose[:3, 3], dirs, t)
    return img, dist, norm[..., 0]


def _hit_ball_scene(origin, dirs, t: float):
    """The colour [..., 3] and the distance to the first hit [...] (inf
    where nothing is hit) of rays from ``origin`` along the unit
    ``dirs`` [..., 3], the ball at time ``t``."""
    center = np.array([0.6 * (t - 0.5), 0.0, 0.15])
    oc = origin - center
    b = np.sum(dirs * oc, axis=-1)
    c = np.sum(oc * oc) - 0.15**2
    disc = b * b - c
    hit_sphere = disc > 0
    t_sphere = np.where(hit_sphere, -b - np.sqrt(np.maximum(disc, 0)), np.inf)

    t_floor = np.where(dirs[..., 2] < -1e-6, (0.0 - origin[2]) / dirs[..., 2], np.inf)

    img = np.zeros(dirs.shape[:-1] + (3,), np.float32)
    sphere_first = hit_sphere & (t_sphere < t_floor) & (t_sphere > 0)
    floor_vis = (t_floor < np.inf) & ~sphere_first & (t_floor > 0)
    img[sphere_first] = [0.9, 0.15, 0.1]
    img[floor_vis] = [0.1, 0.7, 0.2]
    dist = np.where(sphere_first, t_sphere, np.where(floor_vis, t_floor, np.inf))
    return img, dist


def _render_ball_scene(h, w, pose, fx, fy, cx, cy, t: float,
                       distortion=None) -> np.ndarray:
    """The ball scene's image (``_trace_ball_scene``)."""
    return _trace_ball_scene(h, w, pose, fx, fy, cx, cy, t, distortion)[0]


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


# ---------------------------------------------------------------------------
# captures in the formats of the remaining dataparsers and of
# snt-process-data's COLMAP route
# ---------------------------------------------------------------------------

_OPENCV_TO_OPENGL = np.diag([1.0, -1.0, -1.0, 1.0])


def ring_poses(num_frames: int, seed: int = 0, radius: float = 2.5,
               height: float = 0.5) -> np.ndarray:
    """[N, 4, 4] OpenGL camera-to-worlds on a ring around the ball scene,
    looking at its middle, each angle and height jittered from ``seed``."""
    rng = np.random.default_rng(seed)
    poses = []
    for i in range(num_frames):
        theta = 2 * np.pi * i / num_frames + rng.uniform(-0.05, 0.05)
        z = height + rng.uniform(-0.1, 0.1)
        poses.append(_look_at_pose([radius * np.cos(theta),
                                    radius * np.sin(theta), z]))
    return np.stack(poses)


def _save_png(path: Path, img: np.ndarray) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray((img * 255).astype(np.uint8)).save(path)


def _rotmat_to_qvec(R) -> np.ndarray:
    """The unit quaternion (w, x, y, z), w >= 0, of a rotation matrix
    (Shepperd's method: the largest component first)."""
    R = np.asarray(R, np.float64)
    d = np.array([1 + R[0, 0] + R[1, 1] + R[2, 2],
                  1 + R[0, 0] - R[1, 1] - R[2, 2],
                  1 - R[0, 0] + R[1, 1] - R[2, 2],
                  1 - R[0, 0] - R[1, 1] + R[2, 2]])
    i = int(np.argmax(d))
    s = 2.0 * np.sqrt(d[i])
    a, b, c = R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]
    e, f, g = R[0, 1] + R[1, 0], R[0, 2] + R[2, 0], R[1, 2] + R[2, 1]
    q = np.array([(s / 4, a / s, b / s, c / s), (a / s, s / 4, e / s, f / s),
                  (b / s, e / s, s / 4, g / s), (c / s, f / s, g / s, s / 4)][i])
    q /= np.linalg.norm(q)
    return q if q[0] >= 0 else -q


# the camera models the COLMAP fixture writes by default
COLMAP_FIXTURE_MODELS = ("SIMPLE_PINHOLE", "PINHOLE", "SIMPLE_RADIAL", "OPENCV")


def _colmap_camera(model: str, h: int, w: int, rng):
    """(params, distortion (k1, k2, k3, k4, p1, p2) or None, (fx, fy, cx,
    cy)) of a camera of ``model`` at h x w, drawn from ``rng``."""
    f = 0.7 * w * (1 + rng.uniform(-0.02, 0.02))
    fy = f * (1 + rng.uniform(-0.01, 0.01))
    cx, cy = w / 2.0 + rng.uniform(-1, 1), h / 2.0 + rng.uniform(-1, 1)
    if model == "SIMPLE_PINHOLE":
        return [f, cx, cy], None, (f, f, cx, cy)
    if model == "PINHOLE":
        return [f, fy, cx, cy], None, (f, fy, cx, cy)
    if model == "SIMPLE_RADIAL":
        k = rng.uniform(-0.02, 0.02)
        return [f, cx, cy, k], (k, 0, 0, 0, 0, 0), (f, f, cx, cy)
    if model == "OPENCV":
        k1, k2 = rng.uniform(-0.02, 0.02, 2) * np.array([1.0, 0.5])
        p1, p2 = rng.uniform(-1e-3, 1e-3, 2)
        return ([f, fy, cx, cy, k1, k2, p1, p2], (k1, k2, 0, 0, p1, p2),
                (f, fy, cx, cy))
    raise ValueError(f"no fixture camera of model {model}")


def _write_colmap_model(sparse: Path, cameras, images, points, binary: bool):
    """COLMAP's cameras, images and points3D files, binary or text.

    cameras: [(id, model, w, h, params)]; images: [(id, qvec, tvec,
    camera_id, name, xys [P, 2], point3d_ids [P])]; points: (xyz [N, 3],
    rgb [N, 3] uint8)."""
    sparse.mkdir(parents=True, exist_ok=True)
    xyz, rgb = points
    if binary:
        with open(sparse / "cameras.bin", "wb") as f:
            f.write(struct.pack("<Q", len(cameras)))
            for cid, model, w, h, params in cameras:
                f.write(struct.pack("<iiQQ", cid, CAMERA_MODEL_IDS[model], w, h))
                f.write(struct.pack(f"<{len(params)}d", *params))
        with open(sparse / "images.bin", "wb") as f:
            f.write(struct.pack("<Q", len(images)))
            for iid, qvec, tvec, cid, name, xys, ids in images:
                f.write(struct.pack("<i4d3di", iid, *qvec, *tvec, cid))
                f.write(name.encode() + b"\x00")
                f.write(struct.pack("<Q", len(ids)))
                for (x, y), pid in zip(xys, ids):
                    f.write(struct.pack("<ddq", x, y, pid))
        with open(sparse / "points3D.bin", "wb") as f:
            f.write(struct.pack("<Q", len(xyz)))
            for pid, (p, c) in enumerate(zip(xyz, rgb)):
                f.write(struct.pack("<Q3d3Bd", pid, *p, *c, 0.5))
                f.write(struct.pack("<Q", 1))
                f.write(struct.pack("<ii", 1 + pid % len(images), pid))
        return
    lines = ["# Camera list with one line of data per camera:",
             "#   CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]",
             f"# Number of cameras: {len(cameras)}"]
    lines += [" ".join([str(cid), model, str(w), str(h), *map(repr, map(float, params))])
              for cid, model, w, h, params in cameras]
    (sparse / "cameras.txt").write_text("\n".join(lines) + "\n")
    lines = ["# Image list with two lines of data per image:",
             "#   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME",
             "#   POINTS2D[] as (X, Y, POINT3D_ID)"]
    for iid, qvec, tvec, cid, name, xys, ids in images:
        lines.append(" ".join([str(iid), *map(repr, map(float, qvec)),
                               *map(repr, map(float, tvec)), str(cid), name]))
        lines.append(" ".join(f"{float(x)!r} {float(y)!r} {int(pid)}"
                              for (x, y), pid in zip(xys, ids)))
    (sparse / "images.txt").write_text("\n".join(lines) + "\n")
    lines = ["# 3D point list with one line of data per point:",
             "#   POINT3D_ID, X, Y, Z, R, G, B, ERROR, TRACK[] as (IMAGE_ID, POINT2D_IDX)"]
    lines += [" ".join([str(pid), *map(repr, map(float, p)), *map(str, c), "0.5",
                        str(1 + pid % len(images)), str(pid)])
              for pid, (p, c) in enumerate(zip(xyz, rgb))]
    (sparse / "points3D.txt").write_text("\n".join(lines) + "\n")


def _colmap_capture(sparse: Path, image_dir: Path, poses, h, w, models,
                    binary: bool, rng, world) -> None:
    """Render ``poses`` (OpenGL camera-to-worlds in the ball scene) through
    one camera per model in ``models`` (image i through camera i mod
    len(models), of size ``h``, ``w`` or per image), and write their COLMAP
    model: ``world`` [4, 4] maps the ball scene's frame to the one COLMAP
    stores."""
    n = len(poses)
    sizes = [(h, w)] * n if np.ndim(h) == 0 else list(zip(h, w))
    cams, lens = [], []
    for m, model in enumerate(models):
        ch, cw = sizes[m]
        params, distortion, pinhole = _colmap_camera(model, ch, cw, rng)
        cams.append((m + 1, model, cw, ch, params))
        lens.append((pinhole, distortion))
    images = []
    for i, pose in enumerate(poses):
        cid = i % len(models) + 1
        (fx, fy, cx, cy), distortion = lens[cid - 1]
        ch, cw = sizes[cid - 1]
        name = f"frame_{i:05d}.png"
        _save_png(image_dir / name, _render_ball_scene(
            ch, cw, pose, fx, fy, cx, cy, 0.5, distortion))
        w2c = np.linalg.inv(world @ pose @ _OPENCV_TO_OPENGL)
        n_pts = int(rng.integers(1, 6))
        xys = rng.uniform(0, [cw, ch], (n_pts, 2))
        ids = rng.integers(-1, 32, n_pts)
        images.append((i + 1, _rotmat_to_qvec(w2c[:3, :3]), w2c[:3, 3], cid,
                       name, xys, ids))
    # points on the ball (at rest), red
    d = rng.normal(size=(32, 3))
    xyz = np.array([0.0, 0.0, 0.15]) + 0.15 * d / np.linalg.norm(d, axis=1,
                                                                   keepdims=True)
    rgb = np.tile(np.array([229, 38, 25], np.uint8), (32, 1))
    _write_colmap_model(sparse, cams, images, (xyz, rgb), binary)


# colmap_to_transforms' world change, which the COLMAP fixture undoes: its
# rows x and y swapped, z flipped
_COLMAP_TO_NERFSTUDIO_WORLD = np.array([[0.0, 1, 0, 0], [1, 0, 0, 0],
                                        [0, 0, -1, 0], [0, 0, 0, 1]])


def make_colmap_fixture(root: Path, num_frames: int = 8, h: int = 24,
                        w: int = 32, camera_models=COLMAP_FIXTURE_MODELS,
                        binary: bool = True, seed: int = 0) -> Path:
    """A user's COLMAP reconstruction of the ball scene at rest:
    ``images/frame_{i:05d}.png`` seen from ``ring_poses(num_frames, seed)``
    and the sparse model under ``sparse/0`` (binary ``.bin`` or text
    ``.txt`` cameras, images and points3D).  One camera per model in
    ``camera_models`` (image i uses camera i mod their number), with
    intrinsics and small distortions drawn from ``seed``; each image is
    rendered through its camera's distortion.  The stored poses are those
    that ``colmap_to_transforms`` turns back into the ring's
    camera-to-worlds (its world change undone).

    Returns the capture's root; convert it with ``snt-process-data
    colmap-to-json --sparse <root>/sparse/0 --output-dir <root>``."""
    root = Path(root)
    rng = np.random.default_rng([seed, 1])
    _colmap_capture(root / "sparse" / "0", root / "images",
                    ring_poses(num_frames, seed), h, w, camera_models, binary,
                    rng, _COLMAP_TO_NERFSTUDIO_WORLD.T)
    return root


def make_phototourism_fixture(root: Path, num_images: int = 8, h: int = 24,
                              w: int = 32, mixed_sizes: bool = False,
                              seed: int = 0) -> Path:
    """A phototourism layout of the ball scene: ``dense/images`` and a
    binary COLMAP model under ``dense/sparse``, one PINHOLE or
    SIMPLE_PINHOLE camera per image.  ``mixed_sizes`` gives the images
    three different sizes, as a landmark's photo collection has."""
    root = Path(root)
    rng = np.random.default_rng([seed, 2])
    hs = [h + 2 * (i % 3) if mixed_sizes else h for i in range(num_images)]
    ws = [w + 4 * (i % 3) if mixed_sizes else w for i in range(num_images)]
    models = ["PINHOLE" if i % 2 else "SIMPLE_PINHOLE" for i in range(num_images)]
    _colmap_capture(root / "dense" / "sparse", root / "dense" / "images",
                    ring_poses(num_images, seed, height=0.8), hs, ws, models,
                    True, rng, np.eye(4))
    return root


def make_instant_ngp_fixture(root: Path, num_frames: int = 8, h: int = 24,
                             w: int = 32, aabb_scale: int = 1,
                             seed: int = 0) -> Path:
    """An instant-ngp ``transforms.json`` (global intrinsics,
    ``aabb_scale``, per-frame transform matrices) over ``images/``, and one
    frame more whose image is missing."""
    root = Path(root)
    fx = fy = 0.7 * w
    frames = []
    for i, pose in enumerate(ring_poses(num_frames, seed)):
        name = f"images/frame_{i:05d}.png"
        _save_png(root / name, _render_ball_scene(h, w, pose, fx, fy, w / 2,
                                                  h / 2, 0.5))
        frames.append({"file_path": name, "transform_matrix": pose.tolist()})
    frames.append({"file_path": "images/missing.png",
                   "transform_matrix": np.eye(4).tolist()})
    meta = {"fl_x": fx, "fl_y": fy, "cx": w / 2, "cy": h / 2, "w": w, "h": h,
            "aabb_scale": aabb_scale, "frames": frames}
    with open(root / "transforms.json", "w") as f:
        json.dump(meta, f)
    return root


def make_minimal_fixture(root: Path, num_frames: int = 8, h: int = 24,
                         w: int = 32, cameras_as_dict: bool = True,
                         with_times: bool = False, seed: int = 0) -> Path:
    """The minimal parser's ``train.npz``, ``val.npz`` and ``test.npz``
    over ``images/``: every fourth frame is held out for val and test.
    ``cameras_as_dict`` pickles ``Cameras.create``'s arguments as
    ``cameras``, else the cameras' arrays stand beside a placeholder.
    ``with_times`` moves the ball, frame i at time i / (N - 1)."""
    root = Path(root)
    fx = fy = 0.7 * w
    poses = ring_poses(num_frames, seed)
    times = np.linspace(0.0, 1.0, num_frames) if with_times else None
    names = []
    for i, pose in enumerate(poses):
        name = root / "images" / f"frame_{i:05d}.png"
        _save_png(name, _render_ball_scene(h, w, pose, fx, fy, w / 2, h / 2,
                                           0.5 if times is None else times[i]))
        names.append(str(name))
    held = np.arange(num_frames) % 4 == 3
    for split, sel in (("train", ~held), ("val", held), ("test", held)):
        cams = {"camera_to_worlds": poses[sel, :3, :4].astype(np.float32),
                "fx": np.full(sel.sum(), fx, np.float32),
                "fy": np.full(sel.sum(), fy, np.float32),
                "cx": np.full(sel.sum(), w / 2, np.float32),
                "cy": np.full(sel.sum(), h / 2, np.float32),
                "width": np.full(sel.sum(), w, np.int32),
                "height": np.full(sel.sum(), h, np.int32)}
        if times is not None:
            cams["times"] = times[sel].astype(np.float32)
        arrays = ({"cameras": np.array(cams, dtype=object)} if cameras_as_dict
                  else {"cameras": np.zeros(0), **cams})
        np.savez(root / f"{split}.npz",
                 image_filenames=np.array(names)[sel],
                 scene_box=np.array([[-1.5] * 3, [1.5] * 3], np.float32),
                 **arrays)
    return root


def make_dycheck_fixture(root: Path, num_frames: int = 8, h: int = 24,
                         w: int = 32, downscale: int = 2, seed: int = 0) -> Path:
    """A dycheck (iPhone) capture of the moving ball: camera 0 moves along
    an arc over time ids 0 .. N-1 (``splits/train.json``), camera 1 sees
    every other time id, the last among them (``splits/val.json``);
    ``scene.json``'s center and scale, which the parser undoes,
    ``camera/{c}_{t:05d}.json`` at the full size (``downscale`` times
    h x w) and ``rgb/{downscale}x/`` at h x w."""
    root = Path(root)
    rng = np.random.default_rng([seed, 3])
    center, scale = rng.uniform(-0.2, 0.2, 3).tolist(), 0.8
    root.mkdir(parents=True, exist_ok=True)
    with open(root / "scene.json", "w") as f:
        json.dump({"center": center, "scale": scale, "near": 0.05, "far": 10.0}, f)
    (root / "camera").mkdir(exist_ok=True)
    (root / "splits").mkdir(exist_ok=True)
    focal = 0.8 * w * downscale
    pp = (w * downscale / 2.0, h * downscale / 2.0)
    flips = np.array([[1, -1, -1], [-1, 1, 1], [-1, 1, 1]], np.float64)
    last = max(num_frames - 1, 1)
    val_ids = list(range(num_frames - 1, -1, -2))[::-1]
    for split, cam, ids in (("train", 0, list(range(num_frames))),
                            ("val", 1, val_ids)):
        names = []
        for t in ids:
            theta = 0.6 * t / last - 0.3 + (np.pi / 3 if cam else 0.0)
            pose = _look_at_pose([2.5 * np.cos(theta), 2.5 * np.sin(theta),
                                  0.8 + rng.uniform(-0.05, 0.05)])
            name = f"{cam}_{t:05d}"
            orientation = (pose[:3, :3] * flips).T
            position = (pose[:3, 3] * np.array([1, -1, -1]) / scale
                        + np.asarray(center))
            with open(root / "camera" / f"{name}.json", "w") as f:
                json.dump({"orientation": orientation.tolist(),
                           "position": position.tolist(),
                           "focal_length": focal, "principal_point": list(pp),
                           "image_size": [w * downscale, h * downscale],
                           "skew": 0.0, "pixel_aspect_ratio": 1.0,
                           "radial_distortion": [0.0, 0.0, 0.0],
                           "tangential_distortion": [0.0, 0.0]}, f)
            _save_png(root / "rgb" / f"{downscale}x" / f"{name}.png",
                      _render_ball_scene(h, w, pose, focal / downscale,
                                         focal / downscale, pp[0] / downscale,
                                         pp[1] / downscale, t / last))
            names.append(name)
        with open(root / "splits" / f"{split}.json", "w") as f:
            json.dump({"frame_names": names, "time_ids": ids,
                       "camera_ids": [cam] * len(ids)}, f)
    return root


def make_sdfstudio_fixture(root: Path, num_frames: int = 8, h: int = 24,
                           w: int = 32, seed: int = 0) -> Path:
    """An sdfstudio ``meta_data.json`` (size, scene box, per-frame
    ``camtoworld`` and 4 x 4 ``intrinsics``) over ``{i:06d}_rgb.png``, with
    monocular priors beside them: ``{i:06d}_depth.npy`` (the z-depth, 0
    where nothing is hit) and ``{i:06d}_normal.npy`` (a zero normal map)."""
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    fx = fy = 0.7 * w
    K = np.array([[fx, 0, w / 2, 0], [0, fy, h / 2, 0], [0, 0, 1, 0], [0, 0, 0, 1]])
    frames = []
    for i, pose in enumerate(ring_poses(num_frames, seed)):
        img, dist, norm = _trace_ball_scene(h, w, pose, fx, fy, w / 2, h / 2, 0.5)
        _save_png(root / f"{i:06d}_rgb.png", img)
        np.save(root / f"{i:06d}_depth.npy",
                np.where(np.isfinite(dist), dist / norm, 0).astype(np.float32))
        np.save(root / f"{i:06d}_normal.npy", np.zeros((3, h, w), np.float32))
        frames.append({"rgb_path": f"{i:06d}_rgb.png",
                       "camtoworld": pose.tolist(), "intrinsics": K.tolist(),
                       "mono_depth_path": f"{i:06d}_depth.npy",
                       "mono_normal_path": f"{i:06d}_normal.npy"})
    meta = {"camera_model": "OPENCV", "height": h, "width": w,
            "has_mono_prior": True,
            "scene_box": {"aabb": [[-1.5, -1.5, -1.5], [1.5, 1.5, 1.5]],
                          "near": 0.05, "far": 10.0, "radius": 1.5,
                          "collider_type": "near_far"},
            "frames": frames}
    with open(root / "meta_data.json", "w") as f:
        json.dump(meta, f)
    return root


def make_scannet_fixture(root: Path, num_frames: int = 10, h: int = 24,
                         w: int = 32, seed: int = 0) -> Path:
    """A ScanNet sensor dump: ``color/{i}.jpg``, ``pose/{i}.txt`` (OpenCV
    camera-to-world) and ``intrinsic/intrinsic_color.txt``, and one frame
    more whose pose is -inf, as the sensor writes a lost track."""
    root = Path(root)
    for d in ("color", "pose", "intrinsic"):
        (root / d).mkdir(parents=True, exist_ok=True)
    fx = fy = 0.7 * w
    K = np.array([[fx, 0, w / 2, 0], [0, fy, h / 2, 0], [0, 0, 1, 0], [0, 0, 0, 1]])
    np.savetxt(root / "intrinsic" / "intrinsic_color.txt", K)
    poses = ring_poses(num_frames + 1, seed, height=0.8)
    for i, pose in enumerate(poses):
        img = _render_ball_scene(h, w, pose, fx, fy, w / 2, h / 2, 0.5)
        Image.fromarray((img * 255).astype(np.uint8)).save(root / "color" / f"{i}.jpg")
        c2w = (np.full((4, 4), -np.inf) if i == num_frames
               else pose @ _OPENCV_TO_OPENGL)
        np.savetxt(root / "pose" / f"{i}.txt", c2w)
    return root


def make_arkitscenes_fixture(root: Path, num_frames: int = 10, h: int = 24,
                             w: int = 32, video_id: str = "41069021",
                             seed: int = 0) -> Path:
    """An ARKitScenes low-resolution capture under ``root/video_id``:
    ``{id}_frames/lowres_wide/{id}_{ts:.3f}.png``, a ``.pincam`` per frame
    ("w h fx fy cx cy") and ``lowres_wide.traj`` (rows "ts rx ry rz tx ty
    tz": the world-to-camera rotation as axis-angle, then its translation);
    one image more without a trajectory row and one without intrinsics.

    Returns the scene directory (``root/video_id``, pass as ``--data``)."""
    scene = Path(root) / video_id
    frames_dir = scene / f"{video_id}_frames"
    img_dir = frames_dir / "lowres_wide"
    intr_dir = frames_dir / "lowres_wide_intrinsics"
    img_dir.mkdir(parents=True, exist_ok=True)
    intr_dir.mkdir(parents=True, exist_ok=True)
    fx = fy = 0.7 * w
    rows = []
    for i, pose in enumerate(ring_poses(num_frames + 2, seed, height=0.8)):
        ts = f"{6800.0 + 0.1 * i:.3f}"
        _save_png(img_dir / f"{video_id}_{ts}.png",
                  _render_ball_scene(h, w, pose, fx, fy, w / 2, h / 2, 0.5))
        if i != num_frames + 1:
            (intr_dir / f"{video_id}_{ts}.pincam").write_text(
                f"{w} {h} {fx!r} {fy!r} {w / 2!r} {h / 2!r}")
        if i != num_frames:
            w2c = np.linalg.inv(pose @ _OPENCV_TO_OPENGL)
            q = _rotmat_to_qvec(w2c[:3, :3])
            vn = np.linalg.norm(q[1:])
            rotvec = 2 * np.arctan2(vn, q[0]) * q[1:] / max(vn, 1e-300)
            rows.append(" ".join([ts, *(f"{v!r}" for v in map(float, rotvec)),
                                  *(f"{v!r}" for v in map(float, w2c[:3, 3]))]))
    (frames_dir / "lowres_wide.traj").write_text("\n".join(rows) + "\n")
    return scene


def make_equirect_panorama(path: Path, h: int = 512, w: int = 1024,
                           seed: int = 0) -> Path:
    """One equirectangular panorama of the ball scene (longitude -180 to
    180 left to right, latitude +90 to -90 top to bottom, z up) from a
    point above the floor drawn from ``seed``."""
    rng = np.random.default_rng([seed, 4])
    origin = np.array([rng.uniform(-0.3, 0.3), -1.2 + rng.uniform(-0.3, 0.3),
                       0.5 + rng.uniform(-0.1, 0.1)])
    lon = ((np.arange(w) + 0.5) / w - 0.5) * 2 * np.pi
    lat = (0.5 - (np.arange(h) + 0.5) / h) * np.pi
    lat, lon = np.meshgrid(lat, lon, indexing="ij")
    dirs = np.stack([np.cos(lat) * np.cos(lon), np.cos(lat) * np.sin(lon),
                     np.sin(lat)], axis=-1)
    _save_png(Path(path), _hit_ball_scene(origin, dirs, 0.5)[0])
    return Path(path)
