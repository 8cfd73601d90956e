"""Camera pose optimization (counterpart of
soccernerfs_tpu/core/camera_optimizer.py): learned per-camera SE(3) or
SO(3)xR3 pose corrections applied to the training rays, with optional
synthetic pose noise held in a buffer that takes no gradient."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from soccernerfs_tpu_torch.core.lie_groups import exp_map_SE3, exp_map_SO3xR3


@dataclass(frozen=True)
class CameraOptimizerConfig:
    """``mode``: off | SO3xR3 | SE3."""

    mode: str = "off"
    position_noise_std: float = 0.0
    orientation_noise_std: float = 0.0


def init_camera_optimizer(
    cfg: CameraOptimizerConfig, num_cameras: int,
    generator: Optional[torch.Generator] = None, device=None,
) -> dict:
    """Zero pose adjustments, plus the frozen synthetic noise when asked."""
    params = {"pose_adjustment": torch.zeros((num_cameras, 6), device=device)}
    if cfg.position_noise_std != 0.0 or cfg.orientation_noise_std != 0.0:
        assert cfg.position_noise_std >= 0.0 and cfg.orientation_noise_std >= 0.0
        std = torch.tensor(
            [cfg.position_noise_std] * 3 + [cfg.orientation_noise_std] * 3
        )
        noise = torch.randn((num_cameras, 6), generator=generator) * std
        params["pose_noise"] = exp_map_SE3(noise).to(device)  # [N, 3, 4]
    return params


def apply_camera_optimizer(
    cfg: CameraOptimizerConfig,
    params: Optional[dict],
    indices: torch.Tensor,
) -> Optional[torch.Tensor]:
    """Per-ray [R, 3, 4] camera_opt_to_camera correction, or None when off."""
    if cfg.mode == "off" or params is None:
        return None
    adj = params["pose_adjustment"][indices.long()]
    if cfg.mode == "SO3xR3":
        correction = exp_map_SO3xR3(adj)
    elif cfg.mode == "SE3":
        correction = exp_map_SE3(adj)
    else:
        raise ValueError(f"unknown camera optimizer mode {cfg.mode}")
    if "pose_noise" in params:
        noise = params["pose_noise"][indices.long()].detach()
        R1, t1 = noise[..., :3], noise[..., 3:]
        R2, t2 = correction[..., :3], correction[..., 3:]
        correction = torch.cat([R1 @ R2, R1 @ t2 + t1], dim=-1)
    return correction
