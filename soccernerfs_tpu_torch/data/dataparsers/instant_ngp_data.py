"""instant-ngp-format dataparser (counterpart of
soccernerfs_tpu/data/dataparsers/instant_ngp_data.py).

``transforms.json`` (``data`` names it or its directory) with global
intrinsics and distortion, ``aabb_scale`` and per-frame transform
matrices; frames whose image is missing are skipped.  The camera centres
are recentred on their mean and scaled by ``scene_scale``, and the scene
box is the cube of half-side ``aabb_scale``.  Both splits are every frame.
"""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path, PurePath

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
class InstantNGPDataParserConfig(DataParserConfig):
    data: Path = Path("data/ours/posterv2")
    scene_scale: float = 0.33

    def setup(self):
        return InstantNGP(self)


class InstantNGP(DataParser):
    def _generate_dataparser_outputs(self, split="train") -> DataparserOutputs:
        data = Path(self.config.data)
        if data.suffix == ".json":
            meta = load_from_json(data)
            data_dir = data.parent
        else:
            meta = load_from_json(data / "transforms.json")
            data_dir = data

        image_filenames = []
        poses = []
        for frame in meta["frames"]:
            fname = data_dir / Path(str(PurePath(frame["file_path"])))
            if not fname.exists():
                continue
            image_filenames.append(fname)
            poses.append(np.array(frame["transform_matrix"], dtype=np.float32))
        if not image_filenames:
            raise ValueError(f"no images under {data_dir}")
        poses = np.stack(poses)

        camera_to_world = poses[:, :3, :4]
        camera_to_world[..., 3] -= np.mean(camera_to_world[..., 3], axis=0)
        camera_to_world[..., 3] *= self.config.scene_scale

        distortion_params = np.broadcast_to(
            np.array([float(meta.get(k, 0.0))
                      for k in ("k1", "k2", "k3", "k4", "p1", "p2")], np.float32),
            (len(image_filenames), 6),
        ).copy()

        a = float(meta.get("aabb_scale", 1))
        cameras = Cameras.create(
            camera_to_worlds=camera_to_world,
            fx=float(meta["fl_x"]),
            fy=float(meta["fl_y"]),
            cx=float(meta["cx"]),
            cy=float(meta["cy"]),
            width=int(meta["w"]),
            height=int(meta["h"]),
            distortion_params=distortion_params,
            camera_type=CameraType.PERSPECTIVE,
            device="cpu",
        )
        return DataparserOutputs(
            image_filenames=image_filenames,
            cameras=cameras,
            scene_box=SceneBox(aabb=torch.tensor([[-a] * 3, [a] * 3],
                                                 dtype=torch.float32)),
            dataparser_scale=self.config.scene_scale,
        )
