"""Minimal npz dataparser (counterpart of
soccernerfs_tpu/data/dataparsers/minimal.py).

``{split}.npz``, read with ``allow_pickle``: ``image_filenames``,
``scene_box`` [2, 3] and ``cameras``, either a pickled dict of
``Cameras.create``'s arguments or any non-object placeholder, in which
case the cameras come from the arrays ``camera_to_worlds``, ``fx``, ``fy``,
``cx``, ``cy``, ``width``, ``height`` and, when present, ``times``.
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
)


@dataclass
class MinimalDataParserConfig(DataParserConfig):
    data: Path = Path("data/minimal")

    def setup(self):
        return Minimal(self)


class Minimal(DataParser):
    def _generate_dataparser_outputs(self, split="train") -> DataparserOutputs:
        path = Path(self.config.data) / f"{split}.npz"
        data = np.load(path, allow_pickle=True)

        image_filenames = [Path(f) for f in data["image_filenames"].tolist()]
        aabb = torch.from_numpy(np.asarray(data["scene_box"], np.float32))

        cam = data["cameras"].item() if data["cameras"].dtype == object else None
        if cam is not None:
            cameras = Cameras.create(**cam, device="cpu")
        else:
            cameras = Cameras.create(
                camera_to_worlds=np.asarray(data["camera_to_worlds"], np.float32),
                fx=np.asarray(data["fx"], np.float32),
                fy=np.asarray(data["fy"], np.float32),
                cx=np.asarray(data["cx"], np.float32),
                cy=np.asarray(data["cy"], np.float32),
                width=np.asarray(data["width"], np.int32),
                height=np.asarray(data["height"], np.int32),
                camera_type=CameraType.PERSPECTIVE,
                times=(np.asarray(data["times"], np.float32)
                       if "times" in data else None),
                device="cpu",
            )
        return DataparserOutputs(
            image_filenames=image_filenames,
            cameras=cameras,
            scene_box=SceneBox(aabb=aabb),
        )
