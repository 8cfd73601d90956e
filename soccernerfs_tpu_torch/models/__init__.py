"""Model registry: each model module exposes ``Config`` (a frozen
dataclass), ``init``, ``get_outputs``, ``get_metrics_dict``,
``get_loss_dict``, ``proposal_anneal``, ``host_static_kwargs`` and
``train_draws``, and optionally ``prepare_render_params`` (staged render
tables), ``RENDER_OUTPUTS`` (the outputs ``render_camera`` returns, when
more than rgb, depth and accumulation), the non-trainable state's
``init_aux``, ``schedules``, ``eval_kwargs`` and ``update_aux`` (the
occupancy grid) and ``host_update`` (params reshaped on the host between
steps: TensoRF's upsampling)."""
from __future__ import annotations

import importlib

_MODEL_MODULES = {
    "kplanes": "soccernerfs_tpu_torch.models.kplanes",
    "nerfacto": "soccernerfs_tpu_torch.models.nerfacto",
    "depth_nerfacto": "soccernerfs_tpu_torch.models.depth_nerfacto",
    "nerfplayer_nerfacto": "soccernerfs_tpu_torch.models.nerfplayer_nerfacto",
    "instant_ngp": "soccernerfs_tpu_torch.models.instant_ngp",
    "nerfplayer_ngp": "soccernerfs_tpu_torch.models.nerfplayer_ngp",
    "nerfplayer": "soccernerfs_tpu_torch.models.nerfplayer",
    "nerfplayer_ngp_complete": "soccernerfs_tpu_torch.models.nerfplayer_ngp_complete",
    "vanilla_nerf": "soccernerfs_tpu_torch.models.vanilla_nerf",
    "mipnerf": "soccernerfs_tpu_torch.models.mipnerf",
    "tensorf": "soccernerfs_tpu_torch.models.tensorf",
    "semantic_nerfw": "soccernerfs_tpu_torch.models.semantic_nerfw",
    "neus": "soccernerfs_tpu_torch.models.neus",
}


def get_model(name: str):
    """Resolve a model module by registry name."""
    if name not in _MODEL_MODULES:
        raise KeyError(f"unknown model {name!r}; known: {sorted(_MODEL_MODULES)}")
    return importlib.import_module(_MODEL_MODULES[name])


def register_model(name: str, module_path: str):
    """Name a plugin's model module (plugins.py)."""
    _MODEL_MODULES[name] = module_path
