"""HyperNeRF dataparser (counterpart of
soccernerfs_tpu/data/dataparsers/hypernerf.py).

The Nerfies / HyperNeRF capture layout: ``scene.json`` (center, scale),
one ``camera/{left|right}_{t:05d}.json`` per frame (orientation, the
world-to-camera rotation; position; focal_length; principal_point;
image_size; radial and tangential distortion) and the images under
``rgb/{k}x/``.  Poses are recentred and scaled by the scene's center and
scale, then mapped to the nerfstudio convention by the JAX parser's axis
flips; the distortion becomes [k1, k2, k3, 0, p1, p2]; times are the
frame's step over the largest step; a camera's id is its side (left 0,
right 1).  The split interleaves the sides: train is left/even + right/odd
steps, eval the rest.  As in the JAX parser, the auto-scale factor is
reported as ``dataparser_scale`` and not applied to the poses.
"""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from soccernerfs_tpu_torch.core.cameras import Cameras, CameraType
from soccernerfs_tpu_torch.core.scene_box import SceneBox
from soccernerfs_tpu_torch.data.dataparsers.base import (
    DataParser,
    DataParserConfig,
    DataparserOutputs,
    load_from_json,
)

SIDES = {"left": 0, "right": 1}


@dataclass
class HyperNeRFDataParserConfig(DataParserConfig):
    data: Path = Path("data/hypernerf/")
    scale_factor: float = 1.0
    downscale_factor: Optional[int] = 2
    scene_scale: float = 1.5
    auto_scale_poses: bool = True

    def setup(self):
        return HyperNeRF(self)


def is_train_frame(cam_id: int, step: int) -> bool:
    """The interleaved split: left cameras at even steps, right ones at
    odd steps train."""
    return (cam_id == 0 and step % 2 == 0) or (cam_id == 1 and step % 2 == 1)


class HyperNeRF(DataParser):
    def _generate_dataparser_outputs(self, split="train") -> DataparserOutputs:
        config = self.config
        data_dir = Path(config.data)
        scene = load_from_json(data_dir / "scene.json")
        center = np.array(scene["center"], dtype=np.float64)
        scale = float(scene["scale"])

        image_filenames, poses = [], []
        fx, fy, cx, cy, width, height, distort = [], [], [], [], [], [], []
        times, cam_uids = [], []
        for cam_json in sorted((data_dir / "camera").glob("*.json")):
            frame = load_from_json(cam_json)
            stem = cam_json.name.split(".")[0]
            image_filenames.append(
                data_dir / "rgb" / f"{config.downscale_factor}x" / (stem + ".png"))
            cam_uids.append(SIDES.get(stem.split("_")[0], 0))
            times.append(int(stem.split("_")[-1]))

            fx.append(float(frame["focal_length"]))
            fy.append(float(frame["focal_length"]))
            cx.append(float(frame["principal_point"][0]))
            cy.append(float(frame["principal_point"][1]))
            width.append(int(frame["image_size"][0]))
            height.append(int(frame["image_size"][1]))
            rd = frame.get("radial_distortion", [0.0, 0.0, 0.0])
            td = frame.get("tangential_distortion", [0.0, 0.0])
            distort.append([rd[0], rd[1], rd[2], 0.0, td[0], td[1]])

            # world-to-camera orientation and position -> a c2w in the
            # nerfstudio convention, by the JAX parser's axis flips
            rt = np.array(frame["orientation"], dtype=np.float64).T
            p = (np.array(frame["position"], dtype=np.float64) - center) * (
                scale * config.scale_factor)
            pose = np.zeros((3, 4))
            pose[:, :3] = rt * np.array([[1, -1, -1], [-1, 1, 1], [-1, 1, 1]])
            pose[:, 3] = p * np.array([1, -1, -1])
            pose = pose[[1, 0, 2], :]
            pose[2, :] *= -1
            pose = pose[[1, 2, 0], :]
            poses.append(pose)

        if not image_filenames:
            raise FileNotFoundError(f"no hypernerf cameras under {data_dir}/camera")

        indices = [i for i, (cid, t) in enumerate(zip(cam_uids, times))
                   if (split == "train") == is_train_frame(cid, t)]

        poses = np.stack(poses).astype(np.float32)
        scale_factor = 1.0
        if config.auto_scale_poses:
            scale_factor /= float(np.max(np.abs(poses[:, :3, 3])))
        scale_factor *= config.scale_factor

        idx = np.asarray(indices)
        max_t = max(times) if max(times) else 1
        ds = 1.0 / (config.downscale_factor or 1)
        s = config.scene_scale
        cameras = Cameras.create(
            camera_to_worlds=poses[idx, :3, :4],
            fx=np.asarray(fx, np.float32)[idx] * ds,
            fy=np.asarray(fy, np.float32)[idx] * ds,
            cx=np.asarray(cx, np.float32)[idx] * ds,
            cy=np.asarray(cy, np.float32)[idx] * ds,
            width=(np.asarray(width)[idx] * ds).astype(np.int32),
            height=(np.asarray(height)[idx] * ds).astype(np.int32),
            distortion_params=np.asarray(distort, np.float32)[idx],
            camera_type=CameraType.PERSPECTIVE,
            times=np.asarray(times, np.float32)[idx] / max_t,
            ids=np.asarray(cam_uids, np.int32)[idx],
            device="cpu",
        )
        return DataparserOutputs(
            image_filenames=[image_filenames[i] for i in indices],
            cameras=cameras,
            scene_box=SceneBox(aabb=torch.tensor([[-s, -s, -s], [s, s, s]],
                                                 dtype=torch.float32)),
            dataparser_scale=scale_factor,
        )
