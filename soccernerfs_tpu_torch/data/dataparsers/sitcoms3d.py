"""The Sitcoms3D dataparser (counterpart of
soccernerfs_tpu/data/dataparsers/sitcoms3d.py).

``cameras.json`` with per-frame intrinsics and camtoworld and a scene
bbox, rotated so that z is up, centred on the bbox and scaled so that its
longest side is ``scene_scale``; ``images_{d}/`` at the downscale factor;
with ``include_semantics`` the panoptic "thing" label images
(``segmentations_{d}/thing/``) and their classes and colours
(``panoptic_classes.json``), which semantic-nerfw trains on.  Every split
holds every frame, as in the JAX version.
"""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

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


@dataclass
class Sitcoms3DDataParserConfig(DataParserConfig):
    data: Path = Path("data/sitcoms3d/TBBT-big_living_room")
    include_semantics: bool = True
    downscale_factor: int = 4
    scene_scale: float = 2.0

    def setup(self):
        return Sitcoms3D(self)


# 90 degrees about x: the data's y-up frames to z-up
_Z_UP = np.array([[1, 0, 0], [0, 0, -1], [0, 1, 0]], np.float64)


class Sitcoms3D(DataParser):
    def _generate_dataparser_outputs(self, split="train") -> DataparserOutputs:
        config = self.config
        data = Path(config.data)
        cameras_json = load_from_json(data / "cameras.json")
        frames = cameras_json["frames"]
        bbox = np.asarray(cameras_json["bbox"], np.float64)

        suffix = f"_{config.downscale_factor}" if config.downscale_factor != 1 else ""
        image_filenames, fx, fy, cx, cy, c2ws = [], [], [], [], [], []
        for frame in frames:
            image_filenames.append(data / f"images{suffix}" / frame["image_name"])
            K = np.asarray(frame["intrinsics"])
            fx.append(K[0, 0])
            fy.append(K[1, 1])
            cx.append(K[0, 2])
            cy.append(K[1, 2])
            c2ws.append(np.asarray(frame["camtoworld"])[:3])
        c2w = np.stack(c2ws).astype(np.float64)

        c2w[:, :3] = _Z_UP @ c2w[:, :3]
        bbox = (_Z_UP @ bbox.T).T

        aabb = np.sort(bbox, axis=0)
        center = aabb.mean(axis=0)
        aabb -= center
        c2w[..., 3] -= center
        scale = config.scene_scale / (aabb[1] - aabb[0]).max()
        aabb *= scale
        c2w[..., 3] *= scale

        metadata = {}
        if config.include_semantics:
            panoptic = load_from_json(data / "panoptic_classes.json")
            metadata["semantics"] = {
                "filenames": [data / f"segmentations{suffix}" / "thing"
                              / f.name.replace(".jpg", ".png")
                              for f in image_filenames],
                "classes": panoptic["thing"],
                "colors": np.asarray(panoptic["thing_colors"], np.float32) / 255.0,
            }

        ds = 1.0 / config.downscale_factor
        cameras = Cameras.create(
            camera_to_worlds=c2w.astype(np.float32),
            fx=np.asarray(fx, np.float32) * ds,
            fy=np.asarray(fy, np.float32) * ds,
            cx=np.asarray(cx, np.float32) * ds,
            cy=np.asarray(cy, np.float32) * ds,
            width=np.asarray([int(2 * x * ds) for x in cx], np.int32),
            height=np.asarray([int(2 * y * ds) for y in cy], np.int32),
            camera_type=CameraType.PERSPECTIVE,
            device="cpu",
        )
        return DataparserOutputs(
            image_filenames=image_filenames,
            cameras=cameras,
            scene_box=SceneBox(aabb=torch.from_numpy(aabb.astype(np.float32))),
            metadata=metadata,
        )
