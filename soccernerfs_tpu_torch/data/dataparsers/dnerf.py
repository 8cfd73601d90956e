"""D-NeRF dataparser (counterpart of soccernerfs_tpu/data/dataparsers/dnerf.py):
the blender-synthetic layout with a per-frame ``time``, which the blender
parser already reads into the cameras; its own default path."""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

from soccernerfs_tpu_torch.data.dataparsers.blender import (
    Blender,
    BlenderDataParserConfig,
)


@dataclass
class DNeRFDataParserConfig(BlenderDataParserConfig):
    data: Path = Path("data/dnerf/lego")

    def setup(self):
        return Blender(self)
