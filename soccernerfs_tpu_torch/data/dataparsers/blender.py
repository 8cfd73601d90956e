"""Blender-synthetic dataparser (counterpart of
soccernerfs_tpu/data/dataparsers/blender.py)."""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch
from PIL import Image

from soccernerfs_tpu_torch.core.cameras import Cameras, CameraType
from soccernerfs_tpu_torch.core.scene_box import SceneBox
from soccernerfs_tpu_torch.data.dataparsers.base import (
    DataParser,
    DataParserConfig,
    DataparserOutputs,
    load_from_json,
)

COLORS = {"white": (1.0, 1.0, 1.0), "black": (0.0, 0.0, 0.0)}


@dataclass
class BlenderDataParserConfig(DataParserConfig):
    data: Path = Path("data/blender/lego")
    scale_factor: float = 1.0
    alpha_color: str = "white"

    def setup(self):
        return Blender(self)


class Blender(DataParser):
    """NeRF blender-synthetic format: ``transforms_{split}.json`` with
    ``camera_angle_x`` and per-frame extension-less ``file_path``; the
    image size comes from the first image's header."""

    def __init__(self, config: BlenderDataParserConfig):
        super().__init__(config)
        self.data = Path(config.data)

    def _generate_dataparser_outputs(self, split="train") -> DataparserOutputs:
        meta = load_from_json(self.data / f"transforms_{split}.json")
        image_filenames, poses, times = [], [], []
        for frame in meta["frames"]:
            image_filenames.append(
                self.data / Path(frame["file_path"].replace("./", "") + ".png"))
            poses.append(np.array(frame["transform_matrix"]))
            if "time" in frame:
                times.append(frame["time"])
        poses = np.array(poses).astype(np.float32)

        with Image.open(image_filenames[0]) as img0:
            image_width, image_height = img0.size
        camera_angle_x = float(meta["camera_angle_x"])
        focal_length = 0.5 * image_width / np.tan(0.5 * camera_angle_x)

        c2w = poses[:, :3].copy()
        c2w[..., 3] *= self.config.scale_factor

        scene_box = SceneBox(aabb=torch.tensor([[-1.5] * 3, [1.5] * 3]))
        alpha = (np.asarray(COLORS[self.config.alpha_color], np.float32)
                 if self.config.alpha_color in COLORS else None)
        cameras = Cameras.create(
            camera_to_worlds=c2w,
            fx=focal_length,
            fy=focal_length,
            cx=image_width / 2.0,
            cy=image_height / 2.0,
            width=image_width,
            height=image_height,
            camera_type=CameraType.PERSPECTIVE,
            times=np.asarray(times, np.float32) if times else None,
            device="cpu",
        )
        return DataparserOutputs(
            image_filenames=image_filenames,
            cameras=cameras,
            alpha_color=alpha,
            scene_box=scene_box,
            dataparser_scale=self.config.scale_factor,
        )
