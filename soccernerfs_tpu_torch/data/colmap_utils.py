"""COLMAP sparse-model readers (counterpart of
soccernerfs_tpu/data/colmap_utils.py).

numpy readers of COLMAP's cameras, images and points3D, binary and text,
and the conversion of a sparse model to a nerfstudio ``transforms.json``
dict that ``snt-process-data colmap-to-json`` writes: world-to-camera to
camera-to-world, OpenCV to OpenGL camera axes and the world axes swapped
and flipped, all in f64.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Tuple

import numpy as np

# camera model id -> (name, num_params)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
CAMERA_MODEL_IDS = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}


@dataclass
class ColmapCamera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclass
class ColmapImage:
    id: int
    qvec: np.ndarray  # [4] w x y z
    tvec: np.ndarray  # [3]
    camera_id: int
    name: str
    xys: np.ndarray
    point3d_ids: np.ndarray


def qvec2rotmat(q: np.ndarray) -> np.ndarray:
    """The rotation of a unit quaternion (w, x, y, z)."""
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * z * w, 2 * x * z + 2 * y * w],
            [2 * x * y + 2 * z * w, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * x * w],
            [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w, 1 - 2 * x * x - 2 * y * y],
        ]
    )


def _read(f, fmt: str):
    return struct.unpack(fmt, f.read(struct.calcsize(fmt)))


def read_cameras_binary(path: Path) -> Dict[int, ColmapCamera]:
    cameras = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            cam_id, model_id, w, h = _read(f, "<iiQQ")
            name, num_params = CAMERA_MODELS[model_id]
            params = np.array(_read(f, f"<{num_params}d"))
            cameras[cam_id] = ColmapCamera(cam_id, name, int(w), int(h), params)
    return cameras


def read_cameras_text(path: Path) -> Dict[int, ColmapCamera]:
    cameras = {}
    for line in Path(path).read_text().splitlines():
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        cameras[int(parts[0])] = ColmapCamera(
            int(parts[0]), parts[1], int(parts[2]), int(parts[3]),
            np.array([float(p) for p in parts[4:]]),
        )
    return cameras


def read_images_binary(path: Path) -> Dict[int, ColmapImage]:
    images = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            img_id = _read(f, "<i")[0]
            qvec = np.array(_read(f, "<4d"))
            tvec = np.array(_read(f, "<3d"))
            (cam_id,) = _read(f, "<i")
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (n_pts,) = _read(f, "<Q")
            data = np.frombuffer(f.read(24 * n_pts), dtype=np.float64).reshape(-1, 3)
            xys = data[:, :2].copy()
            ids = data[:, 2].view(np.int64)[:].copy() if n_pts else np.zeros(0, np.int64)
            images[img_id] = ColmapImage(
                img_id, qvec, tvec, cam_id, name.decode(), xys, ids
            )
    return images


def read_images_text(path: Path) -> Dict[int, ColmapImage]:
    images = {}
    lines = [
        l for l in Path(path).read_text().splitlines() if l and not l.startswith("#")
    ]
    for i in range(0, len(lines), 2):
        parts = lines[i].split()
        img_id = int(parts[0])
        qvec = np.array([float(p) for p in parts[1:5]])
        tvec = np.array([float(p) for p in parts[5:8]])
        cam_id = int(parts[8])
        name = parts[9]
        pts = lines[i + 1].split() if i + 1 < len(lines) else []
        xys = np.array([float(p) for p in pts]).reshape(-1, 3)[:, :2] if pts else np.zeros((0, 2))
        ids = (
            np.array([int(float(p)) for p in pts[2::3]], np.int64)
            if pts
            else np.zeros(0, np.int64)
        )
        images[img_id] = ColmapImage(img_id, qvec, tvec, cam_id, name, xys, ids)
    return images


def read_points3d_binary(path: Path) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (xyz [N,3], rgb [N,3])."""
    xyzs, rgbs = [], []
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            _pid = _read(f, "<Q")
            xyz = _read(f, "<3d")
            rgb = _read(f, "<3B")
            _err = _read(f, "<d")
            (track_len,) = _read(f, "<Q")
            f.read(8 * track_len)
            xyzs.append(xyz)
            rgbs.append(rgb)
    return np.array(xyzs), np.array(rgbs)


def read_model(sparse_dir: Path):
    """Auto-detect binary vs text model."""
    sparse_dir = Path(sparse_dir)
    if (sparse_dir / "cameras.bin").exists():
        return (
            read_cameras_binary(sparse_dir / "cameras.bin"),
            read_images_binary(sparse_dir / "images.bin"),
        )
    return (
        read_cameras_text(sparse_dir / "cameras.txt"),
        read_images_text(sparse_dir / "images.txt"),
    )


def colmap_to_transforms(
    sparse_dir: Path, image_dir_prefix: str = "images"
) -> dict:
    """A COLMAP sparse model as a nerfstudio-format transforms dict, the
    frames sorted by file path: w2c -> c2w, OpenCV -> OpenGL camera axes
    (flip y, z), world rows x and y swapped and z flipped; per-frame
    intrinsics and the k1, k2, p1, p2 the camera model has."""
    cameras, images = read_model(sparse_dir)

    frames = []
    for img in images.values():
        cam = cameras[img.camera_id]
        R = qvec2rotmat(img.qvec)
        w2c = np.eye(4)
        w2c[:3, :3] = R
        w2c[:3, 3] = img.tvec
        c2w = np.linalg.inv(w2c)
        c2w[0:3, 1:3] *= -1  # OpenCV -> OpenGL camera
        c2w = c2w[np.array([1, 0, 2, 3]), :]  # swap world x/y
        c2w[2, :] *= -1  # flip world z

        if cam.model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL", "SIMPLE_RADIAL_FISHEYE"):
            fx = fy = cam.params[0]
            cx, cy = cam.params[1], cam.params[2]
            k = list(cam.params[3:])
        else:
            fx, fy, cx, cy = cam.params[:4]
            k = list(cam.params[4:])
        frame = {
            "file_path": f"{image_dir_prefix}/{img.name}",
            "fl_x": float(fx),
            "fl_y": float(fy),
            "cx": float(cx),
            "cy": float(cy),
            "w": cam.width,
            "h": cam.height,
            "transform_matrix": c2w.tolist(),
        }
        for i, name in enumerate(("k1", "k2", "p1", "p2")):
            if i < len(k):
                frame[name] = float(k[i])
        frames.append(frame)

    frames.sort(key=lambda fr: fr["file_path"])
    return {"camera_model": "OPENCV", "frames": frames}
