"""Scene bounding box (counterpart of soccernerfs_tpu/core/scene_box.py)."""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class SceneBox:
    """Axis-aligned scene bounds."""

    aabb: torch.Tensor  # [2, 3] min and max corners

    @staticmethod
    def get_normalized_positions(
        positions: torch.Tensor, aabb: torch.Tensor
    ) -> torch.Tensor:
        """Map world positions into [0, 1]^3 w.r.t. the aabb."""
        return (positions - aabb[0]) / (aabb[1] - aabb[0])
