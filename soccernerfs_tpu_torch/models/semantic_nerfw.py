"""Semantic-NeRF-W (counterpart of soccernerfs_tpu/models/semantic_nerfw.py):
nerfacto (models/nerfacto.py, whose forward, draws and schedules it
shares) plus a semantic head: class logits from the geo features of the
final samples, re-encoded through the nerfacto field, composited with the
final weights and supervised with cross-entropy where a batch carries
labels ("semantics" [N] int32).

The geo features are detached unless ``pass_semantic_gradients`` (then
the second density pass runs without a graph), and the weights always
are: the semantic loss reaches ``mlp_semantics`` only, and a step's
hash-grid backward is nerfacto's.  As in the JAX version the transient
embedding is not exposed.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from soccernerfs_tpu_torch.fields.nerfacto import nerfacto_density
from soccernerfs_tpu_torch.models import nerfacto as _nerfacto
from soccernerfs_tpu_torch.models.nerfacto import (  # noqa: F401  (protocol)
    get_metrics_dict,
    host_static_kwargs,
    proposal_anneal,
    sample_counts,
    train_draws,
)
from soccernerfs_tpu_torch.ops.mlp import init_mlp, mlp_apply
from soccernerfs_tpu_torch.ops.rendering import render_semantics


@dataclass(frozen=True)
class Config(_nerfacto.Config):
    """nerfacto's config and the semantic head's; field names and defaults
    are the JAX package's (its ``models/semantic_nerfw.Config``)."""

    num_semantic_classes: int = 100
    semantic_loss_weight: float = 1.0
    pass_semantic_gradients: bool = False


def semantic_mlp_dims(cfg: Config) -> tuple:
    """(in, hidden, hidden layers, out) of ``mlp_semantics``: geo features
    -> 64 x 1 -> class logits."""
    return (cfg.field_config().geo_feat_dim, 64, 1, cfg.num_semantic_classes)


def init(cfg: Config, num_train_data: int = 0,
         generator: Optional[torch.Generator] = None, device=None) -> dict:
    """nerfacto's params, and "mlp_semantics" among the fields."""
    params = _nerfacto.init(cfg, num_train_data, generator, device)
    params["fields"]["mlp_semantics"] = init_mlp(
        *semantic_mlp_dims(cfg), generator=generator, device=device)
    return params


def get_outputs(cfg: Config, params: dict, aabb: torch.Tensor, ray_bundle,
                train: bool = False, anneal: float = 1.0,
                train_proposal_networks: bool = True, jitters=None,
                background=None) -> dict:
    """nerfacto's outputs, and "semantics" [N, C] (composited logits) and
    "semantics_labels" [N] (their argmax)."""
    outputs = _nerfacto.get_outputs(cfg, params, aabb, ray_bundle, train,
                                    anneal, train_proposal_networks, jitters,
                                    background)
    ray_samples = outputs["ray_samples_list"][-1]
    positions = ray_samples.get_positions()
    n, s = positions.shape[:2]
    with torch.set_grad_enabled(torch.is_grad_enabled()
                                and cfg.pass_semantic_gradients):
        _, geo = nerfacto_density(cfg.field_config(), params["fields"], aabb,
                                  positions.reshape(-1, 3))
    logits = mlp_apply(params["fields"]["mlp_semantics"], geo,
                       activation="relu").reshape(n, s, cfg.num_semantic_classes)
    outputs["semantics"] = render_semantics(
        logits, outputs["weights_list"][-1].detach())
    outputs["semantics_labels"] = torch.argmax(outputs["semantics"], dim=-1)
    return outputs


def get_loss_dict(cfg: Config, params: dict, outputs: dict, batch: dict,
                  metrics_dict: dict) -> dict:
    """nerfacto's loss dict, then, for a batch with labels, the mean
    cross-entropy of the composited logits times
    ``semantic_loss_weight``."""
    loss_dict = _nerfacto.get_loss_dict(cfg, params, outputs, batch,
                                        metrics_dict)
    if "semantics" in batch:
        logp = torch.log_softmax(outputs["semantics"], dim=-1)
        labels = batch["semantics"].long()[:, None]
        ce = -torch.gather(logp, -1, labels)[:, 0]
        loss_dict["semantics_loss"] = cfg.semantic_loss_weight * torch.mean(ce)
    return loss_dict
