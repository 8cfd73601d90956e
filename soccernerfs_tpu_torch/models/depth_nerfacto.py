"""Depth-supervised nerfacto (counterpart of
soccernerfs_tpu/models/depth_nerfacto.py): nerfacto (models/nerfacto.py,
whose forward, draws and schedules it shares) plus the DS-NeRF or URF depth
loss on every level's weights, its sigma decaying with the step.  The
targets ("depth_image" [N], 0 where there is none) are z-depths unless
``is_euclidean_depth``.
"""
from __future__ import annotations

from dataclasses import dataclass

from soccernerfs_tpu_torch.models import nerfacto as _nerfacto
from soccernerfs_tpu_torch.models.kplanes import depth_metric
from soccernerfs_tpu_torch.models.nerfacto import (  # noqa: F401  (protocol)
    get_outputs,
    host_static_kwargs,
    init,
    proposal_anneal,
    render_outputs,
    sample_counts,
    train_draws,
)


@dataclass(frozen=True)
class Config(_nerfacto.Config):
    """nerfacto's config and the depth loss's; field names and defaults
    are the JAX package's (its ``models/depth_nerfacto.Config``)."""

    depth_loss_mult: float = 1e-3
    is_euclidean_depth: bool = False
    depth_sigma: float = 0.01
    should_decay_sigma: bool = True
    starting_depth_sigma: float = 0.2
    sigma_decay_rate: float = 0.99985
    depth_loss_type: str = "ds_nerf"


def get_metrics_dict(cfg: Config, outputs: dict, batch: dict, step: int = 0
                     ) -> dict:
    """nerfacto's metrics and, for a batch that carries "depth_image", the
    depth loss at ``step`` (inside the autograd graph)."""
    metrics = _nerfacto.get_metrics_dict(cfg, outputs, batch, step)
    if "depth_image" in batch:
        metrics["depth_loss"] = depth_metric(cfg, outputs, batch, step)
    return metrics


def get_loss_dict(cfg: Config, params: dict, outputs: dict, batch: dict,
                  metrics_dict: dict) -> dict:
    """nerfacto's loss dict, then the depth loss times ``depth_loss_mult``."""
    loss_dict = _nerfacto.get_loss_dict(cfg, params, outputs, batch,
                                        metrics_dict)
    if "depth_loss" in metrics_dict:
        loss_dict["depth_loss"] = cfg.depth_loss_mult * metrics_dict["depth_loss"]
    return loss_dict
