"""Capture-app converters of snt-process-data (counterpart of
soccernerfs_tpu/scripts/capture_converters.py): Polycam, Record3D,
Metashape and RealityCapture exports to a nerfstudio ``transforms.json``
beside a copy of their images, and the ffmpeg commands that extract an
Insta360 capture's frames.  numpy and the standard library; each format's
axis shuffles and sign flips are the JAX package's.
"""
from __future__ import annotations

import csv
import json
import shutil
import subprocess
import xml.etree.ElementTree as ET
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np


def _write_transforms(output_dir: Path, data: dict) -> Path:
    output_dir.mkdir(parents=True, exist_ok=True)
    out = output_dir / "transforms.json"
    with open(out, "w", encoding="utf-8") as f:
        json.dump(data, f, indent=4)
    return out


def _quat_xyzw_to_mat(q: np.ndarray) -> np.ndarray:
    """Scalar-last (x, y, z, w) quaternions -> [.., 3, 3] rotations."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    n = x * x + y * y + z * z + w * w
    s = np.where(n > 0, 2.0 / np.maximum(n, 1e-12), 0.0)
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return np.stack(
        [
            np.stack([1 - (yy + zz), xy - wz, xz + wy], -1),
            np.stack([xy + wz, 1 - (xx + zz), yz - wx], -1),
            np.stack([xz - wy, yz + wx, 1 - (xx + yy)], -1),
        ],
        axis=-2,
    )


# ---------------------------------------------------------------------------
# Polycam (ref: polycam_utils.py:31-99)
# ---------------------------------------------------------------------------

def polycam_to_json(
    data_dir: Path,
    output_dir: Path,
    min_blur_score: float = 25.0,
    crop_border_pixels: int = 15,
    use_uncorrected: bool = False,
) -> List[str]:
    """Convert a Polycam export (keyframes/{images,cameras}) into a
    trainable dataset (per-frame intrinsics; polycam axis convention)."""
    data_dir = Path(data_dir)
    if (data_dir / "keyframes").exists():
        data_dir = data_dir / "keyframes"
    corrected = (data_dir / "corrected_images").exists() and not use_uncorrected
    image_dir = data_dir / ("corrected_images" if corrected else "images")
    cameras_dir = data_dir / ("corrected_cameras" if corrected else "cameras")
    image_filenames = sorted(image_dir.glob("*"))

    img_out = Path(output_dir) / "images"
    img_out.mkdir(parents=True, exist_ok=True)

    frames = []
    skipped = 0
    for i, image_filename in enumerate(image_filenames):
        fj = json.loads((cameras_dir / f"{image_filename.stem}.json").read_text())
        if fj.get("blur_score", np.inf) < min_blur_score:
            skipped += 1
            continue
        name = f"frame_{i + 1:05d}{image_filename.suffix}"
        shutil.copy(image_filename, img_out / name)
        frames.append({
            "fl_x": fj["fx"],
            "fl_y": fj["fy"],
            "cx": fj["cx"] - crop_border_pixels,
            "cy": fj["cy"] - crop_border_pixels,
            "w": fj["width"] - crop_border_pixels * 2,
            "h": fj["height"] - crop_border_pixels * 2,
            "file_path": f"./images/{name}",
            # polycam rows (2, 0, 1) of the stored transform
            # (ref: polycam_utils.py:75-82)
            "transform_matrix": [
                [fj["t_20"], fj["t_21"], fj["t_22"], fj["t_23"]],
                [fj["t_00"], fj["t_01"], fj["t_02"], fj["t_03"]],
                [fj["t_10"], fj["t_11"], fj["t_12"], fj["t_13"]],
                [0.0, 0.0, 0.0, 1.0],
            ],
        })
    data = {
        "camera_model": "OPENCV",
        "orientation_override": "none",
        "frames": frames,
    }
    _write_transforms(Path(output_dir), data)
    summary = []
    if skipped:
        summary.append(f"Skipped {skipped} frames due to low blur score.")
    summary.append(f"Final dataset is {len(frames)} frames.")
    if not frames:
        raise SystemExit("No images remain after filtering")
    return summary


# ---------------------------------------------------------------------------
# Record3D (ref: record3d_utils.py:31-96)
# ---------------------------------------------------------------------------

def record3d_to_json(
    data_dir: Path,
    output_dir: Path,
    max_dataset_size: int = 300,
) -> int:
    """Convert a Record3D capture (rgb/ + metadata[.json]) into a
    trainable dataset.  Poses are scalar-last quaternions + translation."""
    data_dir = Path(data_dir)
    meta_path = data_dir / "metadata.json"
    if not meta_path.exists():
        meta_path = data_dir / "metadata"
    meta = json.loads(meta_path.read_text())

    rgb_dir = data_dir / "rgb"
    images = sorted(rgb_dir.glob("*"), key=lambda p: int(p.stem))
    indices = np.arange(len(images))
    if max_dataset_size > 0 and len(images) > max_dataset_size:
        indices = np.linspace(0, len(images) - 1, max_dataset_size).astype(int)
        images = [images[i] for i in indices]

    poses = np.asarray(meta["poses"], np.float64)               # [N, 7]
    c2w = np.concatenate(
        [_quat_xyzw_to_mat(poses[:, :4]), poses[:, 4:, None]], axis=-1
    ).astype(np.float32)[indices]

    img_out = Path(output_dir) / "images"
    img_out.mkdir(parents=True, exist_ok=True)
    frames = []
    for i, (im, m) in enumerate(zip(images, c2w)):
        name = f"frame_{i + 1:05d}{im.suffix}"
        shutil.copy(im, img_out / name)
        mat = np.concatenate([m, [[0, 0, 0, 1]]], 0)
        frames.append({
            "file_path": f"./images/{name}",
            "transform_matrix": mat.tolist(),
        })

    k = np.asarray(meta["K"], np.float64).reshape(3, 3).T
    out = {
        "fl_x": float(k[0, 0]),
        "fl_y": float(k[0, 0]),
        "cx": meta["w"] / 2.0,
        "cy": meta["h"] / 2.0,
        "w": meta["w"],
        "h": meta["h"],
        "camera_model": "OPENCV",
        "frames": frames,
    }
    _write_transforms(Path(output_dir), out)
    return len(frames)


# ---------------------------------------------------------------------------
# Metashape (ref: metashape_utils.py:38-145)
# ---------------------------------------------------------------------------

def metashape_to_json(
    xml_filename: Path,
    image_dir: Path,
    output_dir: Path,
) -> List[str]:
    """Convert a Metashape cameras.xml + source images into a dataset."""
    root = ET.parse(xml_filename).getroot()
    chunk = root[0]
    sensors = chunk.find("sensors")
    if sensors is None:
        raise ValueError("No sensors found in Metashape XML")
    calibrated = [s for s in sensors if s.find("calibration") is not None]
    if len(calibrated) != 1:
        raise ValueError("Only one calibrated sensor is supported")
    sensor = calibrated[0]
    reso = sensor.find("resolution")
    calib = sensor.find("calibration")

    def dist(name):
        el = calib.find(name)
        return float(el.text) if el is not None else 0.0

    w = int(reso.get("width"))
    h = int(reso.get("height"))
    data = {
        "w": w,
        "h": h,
        "fl_x": float(calib.find("f").text),
        "fl_y": float(calib.find("f").text),
        "cx": dist("cx") + w / 2.0,
        "cy": dist("cy") + h / 2.0,
        "k1": dist("k1"), "k2": dist("k2"), "k3": dist("k3"), "k4": dist("k4"),
        "p1": dist("p1"), "p2": dist("p2"),
        "camera_model": "OPENCV",
    }

    image_dir = Path(image_dir)
    image_map: Dict[str, Path] = {}
    img_out = Path(output_dir) / "images"
    img_out.mkdir(parents=True, exist_ok=True)
    for p in sorted(image_dir.glob("*")):
        if p.suffix.lower() in (".png", ".jpg", ".jpeg"):
            shutil.copy(p, img_out / p.name)
            image_map[p.stem] = Path("images") / p.name

    frames = []
    skipped = 0
    for camera in chunk.find("cameras"):
        label = camera.get("label").split(".")[0]
        if label not in image_map:
            continue
        if camera.get("sensor_id") != sensor.get("id") or camera.find("transform") is None:
            skipped += 1
            continue
        t = [float(x) for x in camera.find("transform").text.split()]
        # nerfstudio world convention (ref: metashape_utils.py:118-126)
        transform = [
            [t[8], -t[9], -t[10], t[11]],
            [t[0], -t[1], -t[2], t[3]],
            [t[4], -t[5], -t[6], t[7]],
            [t[12], -t[13], -t[14], t[15]],
        ]
        frames.append({
            "file_path": image_map[label].as_posix(),
            "transform_matrix": transform,
        })
    data["frames"] = frames
    _write_transforms(Path(output_dir), data)
    summary = []
    if skipped:
        summary.append(f"{skipped} images skipped (missing pose/calibration).")
    summary.append(f"Final dataset is {len(frames)} frames.")
    return summary


# ---------------------------------------------------------------------------
# RealityCapture (ref: realitycapture_utils.py:31-135)
# ---------------------------------------------------------------------------

def _rc_rotation(yaw, pitch, roll):
    sy, cy = np.sin(np.deg2rad(yaw)), np.cos(np.deg2rad(yaw))
    sp, cp = np.sin(np.deg2rad(pitch)), np.cos(np.deg2rad(pitch))
    sr, cr = np.sin(np.deg2rad(roll)), np.cos(np.deg2rad(roll))
    rot_x = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
    rot_y = np.array([[cr, 0, sr], [0, 1, 0], [-sr, 0, cr]])
    rot_z = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return rot_z @ rot_x @ rot_y


def realitycapture_to_json(
    csv_filename: Path,
    image_dir: Path,
    output_dir: Path,
) -> List[str]:
    """Convert a RealityCapture camera CSV + images into a dataset."""
    from PIL import Image

    with open(csv_filename, encoding="utf-8") as f:
        rows = list(csv.DictReader(f))

    image_dir = Path(image_dir)
    img_out = Path(output_dir) / "images"
    img_out.mkdir(parents=True, exist_ok=True)
    image_map: Dict[str, Path] = {}
    for p in sorted(image_dir.glob("*")):
        if p.suffix.lower() in (".png", ".jpg", ".jpeg"):
            shutil.copy(p, img_out / p.name)
            image_map[p.stem] = Path("images") / p.name

    first = next((r for r in rows if r["#name"].split(".")[0] in image_map), None)
    if first is None:
        raise SystemExit("no CSV rows match any image")
    w, h = Image.open(
        Path(output_dir) / image_map[first["#name"].split(".")[0]]
    ).size

    data = {
        "camera_model": "OPENCV",
        "orientation_override": "none",
        "w": int(w),
        "h": int(h),
    }
    frames = []
    missing = 0
    for row in rows:
        base = row["#name"].split(".")[0]
        if base not in image_map:
            missing += 1
            continue
        transform = np.eye(4)
        transform[:3, :3] = _rc_rotation(
            -float(row["heading"]), float(row["pitch"]), float(row["roll"])
        )
        transform[:3, 3] = [float(row["x"]), float(row["y"]), float(row["alt"])]
        frames.append({
            "file_path": image_map[base].as_posix(),
            "fl_x": float(row["f"]) * max(w, h) / 36.0,
            "fl_y": float(row["f"]) * max(w, h) / 36.0,
            "cx": float(row["px"]) / 36.0 + w / 2.0,
            "cy": float(row["py"]) / 36.0 + h / 2.0,
            "k1": row["k1"], "k2": row["k2"], "k3": row["k3"], "k4": row["k4"],
            "p1": row["t1"], "p2": row["t2"],
            "transform_matrix": transform.tolist(),
        })
    data["frames"] = frames
    _write_transforms(Path(output_dir), data)
    summary = []
    if missing:
        summary.append(f"Missing image data for {missing} cameras.")
    summary.append(f"Final dataset is {len(frames)} frames.")
    return summary


# ---------------------------------------------------------------------------
# Insta360 (ref: insta360_utils.py:30-180) — ffmpeg frame extraction
# ---------------------------------------------------------------------------

def insta360_ffmpeg_commands(
    video_front: Path,
    video_back: Optional[Path],
    image_dir: Path,
    num_frames_target: int = 300,
    crop_percentage: float = 0.7,
) -> List[List[str]]:
    """Build the ffmpeg commands extracting cropped perspective frames from
    an Insta360 dual-fisheye capture (single .insv or front/back pair)."""
    cmds = []
    if video_back is None:
        # single-file: both lenses side by side (ref: insta360_utils.py:125-171)
        for side, crop in (
            ("front", f"crop=ih*{crop_percentage}:ih*{crop_percentage}"
                      f":ih*{crop_percentage}/4:ih*{crop_percentage}/4"),
            ("back", f"crop=ih*{crop_percentage}:ih*{crop_percentage}"
                     f":iw/2+ih*{crop_percentage / 4}:ih*{crop_percentage}/4"),
        ):
            cmds.append([
                "ffmpeg", "-i", str(video_front),
                "-vf", f"{crop},thumbnail={max(1, num_frames_target)}",
                "-vsync", "vfr",
                str(Path(image_dir) / f"frame_{side}_%05d.png"),
            ])
    else:
        for name, video in (("front", video_front), ("back", video_back)):
            cmds.append([
                "ffmpeg", "-i", str(video),
                "-vf",
                f"crop=iw*{crop_percentage}:ih*{crop_percentage},"
                f"thumbnail={max(1, num_frames_target)}",
                "-vsync", "vfr",
                str(Path(image_dir) / f"frame_{name}_%05d.png"),
            ])
    return cmds


def convert_insta360(
    data: Path,
    output_dir: Path,
    num_frames_target: int = 300,
) -> None:
    """Extract frames from an Insta360 capture with ffmpeg, then leave the
    images ready for the COLMAP pipeline (snt-process-data images)."""
    data = Path(data)
    if data.is_file():
        front, back = data, None
    else:
        vids = sorted(data.glob("*.insv")) + sorted(data.glob("*.mp4"))
        front = next((v for v in vids if "_00_" in v.name), vids[0] if vids else None)
        back = next((v for v in vids if "_10_" in v.name), None)
    if front is None:
        raise SystemExit(f"no .insv/.mp4 videos found under {data}")
    if shutil.which("ffmpeg") is None:
        raise SystemExit("ffmpeg is required for insta360 extraction")
    image_dir = Path(output_dir) / "images"
    image_dir.mkdir(parents=True, exist_ok=True)
    for cmd in insta360_ffmpeg_commands(front, back, image_dir, num_frames_target):
        print("Running:", " ".join(cmd), flush=True)
        subprocess.run(cmd, check=True)
    print("frames extracted; run `snt-process-data images` to pose them")
