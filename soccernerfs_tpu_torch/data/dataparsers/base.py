"""Dataparser base types (counterpart of
soccernerfs_tpu/data/dataparsers/base.py).

A parser's ``DataparserOutputs`` holds the port's ``Cameras`` on the CPU;
whoever trains or renders moves them to its device.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

from soccernerfs_tpu_torch.core.cameras import Cameras
from soccernerfs_tpu_torch.core.scene_box import SceneBox


def load_from_json(filename: Path) -> dict:
    if not str(filename).endswith(".json"):
        raise ValueError(f"{filename} is not a .json file")
    with open(filename, encoding="UTF-8") as f:
        return json.load(f)


@dataclass
class DataparserOutputs:
    """A parsed split: image files, cameras (on the CPU), scene box."""

    image_filenames: List[Path]
    cameras: Cameras
    scene_box: SceneBox
    alpha_color: Optional[np.ndarray] = None
    mask_filenames: Optional[List[Path]] = None
    dataparser_scale: float = 1.0
    dataparser_transform: np.ndarray = field(
        default_factory=lambda: np.eye(4, dtype=np.float32)[:3]
    )
    metadata: Dict[str, Any] = field(default_factory=dict)

    def save_dataparser_transform(self, path: Path) -> None:
        """Write the transform and scale the parser applied, so other
        software can map back to the data's own coordinates."""
        data = {
            "transform": np.asarray(self.dataparser_transform).tolist(),
            "scale": float(self.dataparser_scale),
        }
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "w", encoding="UTF-8") as f:
            json.dump(data, f, indent=4)


@dataclass
class DataParserConfig:
    data: Path = Path()

    def setup(self) -> "DataParser":
        raise NotImplementedError


class DataParser:
    """Subclasses implement ``_generate_dataparser_outputs``."""

    def __init__(self, config: DataParserConfig):
        self.config = config

    def _generate_dataparser_outputs(self, split: str = "train") -> DataparserOutputs:
        raise NotImplementedError

    def get_dataparser_outputs(self, split: str = "train") -> DataparserOutputs:
        return self._generate_dataparser_outputs(split)
