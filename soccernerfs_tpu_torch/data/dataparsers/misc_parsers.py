"""The remaining upstream dataparsers (counterpart of
soccernerfs_tpu/data/dataparsers/misc_parsers.py): phototourism, dycheck,
sdfstudio, scannet, arkitscenes and nuscenes, each reading its format's
essentials with the JAX parser's arithmetic (f64 poses, then f32).

nuscenes refuses: without the devkit it exits, with it it raises
``NotImplementedError``, as the JAX parser does.
"""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from soccernerfs_tpu_torch.core.cameras import Cameras
from soccernerfs_tpu_torch.core.pose_utils import auto_orient_and_center_poses
from soccernerfs_tpu_torch.core.scene_box import SceneBox
from soccernerfs_tpu_torch.data.colmap_utils import qvec2rotmat, read_model
from soccernerfs_tpu_torch.data.dataparsers.base import (
    DataParser,
    DataParserConfig,
    DataparserOutputs,
    load_from_json,
)


def _fraction_split(n: int, fraction: float, split: str) -> np.ndarray:
    """Equally spaced train frames; eval is the rest."""
    num_train = int(np.ceil(n * fraction))
    i_train = np.linspace(0, n - 1, num_train, dtype=int)
    if split == "train":
        return i_train
    return np.setdiff1d(np.arange(n), i_train)


def _cube(s: float) -> SceneBox:
    return SceneBox(aabb=torch.tensor([[-s] * 3, [s] * 3], dtype=torch.float32))


# ---------------------------------------------------------------------------
# phototourism: a COLMAP reconstruction of a landmark's photo collection,
# under dense/sparse (or sparse/0), its images under dense/images, each
# image with its own size
# ---------------------------------------------------------------------------

@dataclass
class PhototourismDataParserConfig(DataParserConfig):
    data: Path = Path("data/phototourism/brandenburg-gate")
    train_split_fraction: float = 0.9
    scale_factor: float = 3.0
    scene_scale: float = 1.0
    orientation_method: str = "up"
    center_method: str = "poses"
    auto_scale_poses: bool = True

    def setup(self):
        return Phototourism(self)


class Phototourism(DataParser):
    def _generate_dataparser_outputs(self, split="train") -> DataparserOutputs:
        config = self.config
        sparse = Path(config.data) / "dense" / "sparse"
        if not sparse.exists():
            sparse = Path(config.data) / "sparse" / "0"
        cams, imgs = read_model(sparse)

        image_filenames, poses = [], []
        fxs, fys, cxs, cys, ws, hs = [], [], [], [], [], []
        for img in sorted(imgs.values(), key=lambda im: im.name):
            cam = cams[img.camera_id]
            w2c = np.eye(4)
            w2c[:3, :3] = qvec2rotmat(img.qvec)
            w2c[:3, 3] = img.tvec
            c2w = np.linalg.inv(w2c)
            c2w[0:3, 1:3] *= -1
            poses.append(c2w)
            image_filenames.append(Path(config.data) / "dense" / "images" / img.name)
            if cam.model.startswith("SIMPLE"):
                fx = fy = cam.params[0]
                cx, cy = cam.params[1], cam.params[2]
            else:
                fx, fy, cx, cy = cam.params[:4]
            fxs.append(fx)
            fys.append(fy)
            cxs.append(cx)
            cys.append(cy)
            ws.append(cam.width)
            hs.append(cam.height)

        poses = np.stack(poses).astype(np.float32)
        poses, transform = auto_orient_and_center_poses(
            poses, config.orientation_method, config.center_method)
        scale = 1.0
        if config.auto_scale_poses:
            scale /= float(np.max(np.abs(poses[:, :3, 3])))
        scale *= config.scale_factor
        poses[:, :3, 3] *= scale

        idx = _fraction_split(len(image_filenames), config.train_split_fraction, split)
        cameras = Cameras.create(
            camera_to_worlds=poses[idx, :3, :4],
            fx=np.asarray(fxs, np.float32)[idx],
            fy=np.asarray(fys, np.float32)[idx],
            cx=np.asarray(cxs, np.float32)[idx],
            cy=np.asarray(cys, np.float32)[idx],
            width=np.asarray(ws, np.int32)[idx],
            height=np.asarray(hs, np.int32)[idx],
            device="cpu",
        )
        return DataparserOutputs(
            image_filenames=[image_filenames[i] for i in idx],
            cameras=cameras,
            scene_box=_cube(config.scene_scale),
            dataparser_scale=scale,
            dataparser_transform=transform,
        )


# ---------------------------------------------------------------------------
# dycheck: iPhone captures; splits/{train,val}.json (frame names and time
# ids), scene.json (center, scale), camera/{name}.json as in HyperNeRF,
# images under rgb/{k}x/
# ---------------------------------------------------------------------------

@dataclass
class DycheckDataParserConfig(DataParserConfig):
    data: Path = Path("data/iphone/mochi-high-five")
    downscale_factor: int = 2
    scene_scale: float = 1.5

    def setup(self):
        return Dycheck(self)


class Dycheck(DataParser):
    def _generate_dataparser_outputs(self, split="train") -> DataparserOutputs:
        config = self.config
        data = Path(config.data)
        split_file = data / "splits" / f"{split if split == 'train' else 'val'}.json"
        split_meta = load_from_json(split_file)
        names = split_meta["frame_names"]
        times = np.asarray(split_meta["time_ids"], np.float32)
        times = times / max(times.max(), 1)

        scene = load_from_json(data / "scene.json")
        center = np.asarray(scene["center"], np.float64)
        scale = float(scene["scale"])

        image_filenames, poses = [], []
        fxs, cxs, cys, ws, hs = [], [], [], [], []
        ds = config.downscale_factor
        for name in names:
            cam = load_from_json(data / "camera" / f"{name}.json")
            image_filenames.append(data / "rgb" / f"{ds}x" / f"{name}.png")
            Rt = np.asarray(cam["orientation"]).T
            p = (np.asarray(cam["position"]) - center) * scale
            pose = np.zeros((3, 4))
            pose[:, :3] = Rt * np.array([[1, -1, -1], [-1, 1, 1], [-1, 1, 1]])
            pose[:, 3] = p * np.array([1, -1, -1])
            poses.append(pose)
            fxs.append(cam["focal_length"])
            cxs.append(cam["principal_point"][0])
            cys.append(cam["principal_point"][1])
            ws.append(cam["image_size"][0])
            hs.append(cam["image_size"][1])

        inv = 1.0 / ds
        cameras = Cameras.create(
            camera_to_worlds=np.stack(poses).astype(np.float32),
            fx=np.asarray(fxs, np.float32) * inv,
            fy=np.asarray(fxs, np.float32) * inv,
            cx=np.asarray(cxs, np.float32) * inv,
            cy=np.asarray(cys, np.float32) * inv,
            width=(np.asarray(ws) * inv).astype(np.int32),
            height=(np.asarray(hs) * inv).astype(np.int32),
            times=times,
            device="cpu",
        )
        return DataparserOutputs(
            image_filenames=image_filenames,
            cameras=cameras,
            scene_box=_cube(config.scene_scale),
            dataparser_scale=scale,
        )


# ---------------------------------------------------------------------------
# sdfstudio: meta_data.json with per-frame intrinsics and camtoworld and
# optional monocular depth and normal priors; both splits are every frame
# ---------------------------------------------------------------------------

@dataclass
class SDFStudioDataParserConfig(DataParserConfig):
    data: Path = Path("data/sdfstudio-demo-data/dtu-scan65")
    include_mono_prior: bool = False

    def setup(self):
        return SDFStudio(self)


class SDFStudio(DataParser):
    def _generate_dataparser_outputs(self, split="train") -> DataparserOutputs:
        data = Path(self.config.data)
        meta = load_from_json(data / "meta_data.json")
        image_filenames, poses, Ks = [], [], []
        depth_filenames, normal_filenames = [], []
        for frame in meta["frames"]:
            image_filenames.append(data / frame["rgb_path"])
            poses.append(np.asarray(frame["camtoworld"])[:3])
            Ks.append(np.asarray(frame["intrinsics"]))
            if self.config.include_mono_prior:
                depth_filenames.append(data / frame["mono_depth_path"])
                normal_filenames.append(data / frame["mono_normal_path"])
        K = np.stack(Ks)
        box = meta.get("scene_box", {})
        aabb = np.asarray(box.get("aabb", [[-1, -1, -1], [1, 1, 1]]), np.float32)
        cameras = Cameras.create(
            camera_to_worlds=np.stack(poses).astype(np.float32),
            fx=K[:, 0, 0].astype(np.float32),
            fy=K[:, 1, 1].astype(np.float32),
            cx=K[:, 0, 2].astype(np.float32),
            cy=K[:, 1, 2].astype(np.float32),
            width=int(meta["width"]),
            height=int(meta["height"]),
            device="cpu",
        )
        return DataparserOutputs(
            image_filenames=image_filenames,
            cameras=cameras,
            scene_box=SceneBox(aabb=torch.from_numpy(aabb)),
            metadata={
                "depth_filenames": depth_filenames or None,
                "normal_filenames": normal_filenames or None,
                "depth_unit_scale_factor": 1.0,
            },
        )


# ---------------------------------------------------------------------------
# scannet: sensor dumps, color/{i}.jpg, pose/{i}.txt (OpenCV c2w; frames
# whose pose is not finite are dropped) and intrinsic/intrinsic_color.txt
# ---------------------------------------------------------------------------

@dataclass
class ScanNetDataParserConfig(DataParserConfig):
    data: Path = Path("data/scannet/scene0423_02")
    train_split_fraction: float = 0.9
    scene_scale: float = 1.5

    def setup(self):
        return ScanNet(self)


class ScanNet(DataParser):
    def _generate_dataparser_outputs(self, split="train") -> DataparserOutputs:
        from PIL import Image

        config = self.config
        data = Path(config.data)
        img_dir = data / "color"
        pose_dir = data / "pose"
        K = np.loadtxt(data / "intrinsic" / "intrinsic_color.txt")

        image_filenames, poses = [], []
        for img in sorted(img_dir.iterdir(), key=lambda p: int(p.stem)):
            pose = np.loadtxt(pose_dir / f"{img.stem}.txt")
            if not np.all(np.isfinite(pose)):
                continue
            pose[0:3, 1:3] *= -1  # OpenCV -> OpenGL
            poses.append(pose)
            image_filenames.append(img)
        poses = np.stack(poses).astype(np.float32)
        poses, transform = auto_orient_and_center_poses(poses, "up", "poses")
        scale = 1.0 / max(float(np.max(np.abs(poses[:, :3, 3]))), 1e-8)
        poses[:, :3, 3] *= scale

        with Image.open(image_filenames[0]) as im0:
            w, h = im0.size
        idx = _fraction_split(len(image_filenames), config.train_split_fraction, split)
        cameras = Cameras.create(
            camera_to_worlds=poses[idx, :3, :4],
            fx=float(K[0, 0]),
            fy=float(K[1, 1]),
            cx=float(K[0, 2]),
            cy=float(K[1, 2]),
            width=w,
            height=h,
            device="cpu",
        )
        return DataparserOutputs(
            image_filenames=[image_filenames[i] for i in idx],
            cameras=cameras,
            scene_box=_cube(config.scene_scale),
            dataparser_scale=scale,
            dataparser_transform=transform,
        )


# ---------------------------------------------------------------------------
# arkitscenes: low-resolution ARKit captures, {id}_frames/lowres_wide.traj
# (rows "ts rx ry rz tx ty tz", axis-angle world-to-camera) and per-frame
# lowres_wide_intrinsics/*.pincam ("w h fx fy cx cy")
# ---------------------------------------------------------------------------

@dataclass
class ARKitScenesDataParserConfig(DataParserConfig):
    data: Path = Path("data/arkitscenes/41069021")
    train_split_fraction: float = 0.9
    scene_scale: float = 1.0

    def setup(self):
        return ARKitScenes(self)


class ARKitScenes(DataParser):
    @staticmethod
    def _traj_to_poses(traj_path: Path):
        """Camera-to-world of each ``.traj`` row, keyed by its timestamp
        rounded to 3 decimals."""
        poses = {}
        for line in traj_path.read_text().splitlines():
            vals = [float(v) for v in line.split()]
            ts, rot, t = vals[0], np.asarray(vals[1:4]), np.asarray(vals[4:7])
            angle = np.linalg.norm(rot)
            axis = rot / max(angle, 1e-12)
            K = np.array(
                [[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]]
            )
            R = np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * (K @ K)
            w2c = np.eye(4)
            w2c[:3, :3] = R
            w2c[:3, 3] = t
            poses[round(ts, 3)] = np.linalg.inv(w2c)
        return poses

    def _generate_dataparser_outputs(self, split="train") -> DataparserOutputs:
        config = self.config
        data = Path(config.data)
        video_id = data.name
        traj = self._traj_to_poses(data / f"{video_id}_frames" / "lowres_wide.traj")
        img_dir = data / f"{video_id}_frames" / "lowres_wide"
        intr_dir = data / f"{video_id}_frames" / "lowres_wide_intrinsics"

        image_filenames, poses, intr = [], [], []
        for img in sorted(img_dir.glob("*.png")):
            ts = round(float(img.stem.split("_")[1]), 3)
            if ts not in traj:
                continue
            pincam = intr_dir / (img.stem + ".pincam")
            if not pincam.exists():
                continue
            w, h, fx, fy, cx, cy = [float(v) for v in pincam.read_text().split()]
            c2w = traj[ts].copy()
            c2w[0:3, 1:3] *= -1
            poses.append(c2w)
            intr.append((w, h, fx, fy, cx, cy))
            image_filenames.append(img)

        poses = np.stack(poses).astype(np.float32)
        poses, transform = auto_orient_and_center_poses(poses, "up", "poses")
        scale = 1.0 / max(float(np.max(np.abs(poses[:, :3, 3]))), 1e-8)
        poses[:, :3, 3] *= scale

        idx = _fraction_split(len(image_filenames), config.train_split_fraction, split)
        intr_arr = np.asarray(intr, np.float32)
        cameras = Cameras.create(
            camera_to_worlds=poses[idx, :3, :4],
            fx=intr_arr[idx, 2],
            fy=intr_arr[idx, 3],
            cx=intr_arr[idx, 4],
            cy=intr_arr[idx, 5],
            width=intr_arr[idx, 0].astype(np.int32),
            height=intr_arr[idx, 1].astype(np.int32),
            device="cpu",
        )
        return DataparserOutputs(
            image_filenames=[image_filenames[i] for i in idx],
            cameras=cameras,
            scene_box=_cube(config.scene_scale),
            dataparser_scale=scale,
            dataparser_transform=transform,
        )


# ---------------------------------------------------------------------------
# nuscenes: needs the nuscenes devkit and its database; refuses
# ---------------------------------------------------------------------------

@dataclass
class NuScenesDataParserConfig(DataParserConfig):
    data: Path = Path("scene-0103")
    data_dir: Path = Path("/mnt/local/NuScenes")
    version: str = "v1.0-mini"
    cameras: tuple = ("FRONT",)
    train_split_fraction: float = 0.9

    def setup(self):
        return NuScenes(self)


class NuScenes(DataParser):
    def _generate_dataparser_outputs(self, split="train") -> DataparserOutputs:
        try:
            from nuscenes.nuscenes import NuScenes as NuScenesDB  # noqa: F401
        except ImportError:
            raise SystemExit(
                "the nuscenes-devkit package is required for nuscenes-data "
                "(pip install nuscenes-devkit); it is not bundled here"
            )
        raise NotImplementedError(
            "nuscenes parsing requires the devkit database at runtime"
        )
