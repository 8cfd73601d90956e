"""Configs of the registered methods the port runs (counterpart of
soccernerfs_tpu/configs/method_configs.py; the values are copied): the
model and its registry name, the per-group optimizers and schedules, the
camera optimizer, and the rays per train batch.
"""
from __future__ import annotations

from typing import Any, Dict

from soccernerfs_tpu_torch.core.camera_optimizer import CameraOptimizerConfig
from soccernerfs_tpu_torch.engine.optimizers import AdamOptimizerConfig
from soccernerfs_tpu_torch.engine.schedulers import CosineDecaySchedulerConfig
from soccernerfs_tpu_torch.models import instant_ngp as ingp_model
from soccernerfs_tpu_torch.models import kplanes as kplanes_model
from soccernerfs_tpu_torch.models import nerfacto as nerfacto_model
from soccernerfs_tpu_torch.models import nerfplayer as np_model
from soccernerfs_tpu_torch.models import nerfplayer_nerfacto as npn_model
from soccernerfs_tpu_torch.models import nerfplayer_ngp as npngp_model
from soccernerfs_tpu_torch.models import nerfplayer_ngp_complete as npngpc_model

# K-Planes loss coefficients of the fork's methods
_KPLANES_LOSS_COEF = (
    ("rgb_loss", 1.0),
    ("interlevel_loss", 1.0),
    ("distortion_loss", 0.001),
    ("space_tv_loss", 0.02),
    ("time_smoothness_loss", 1.0),
    ("sparse_transients_loss", 0.001),
    ("space_tv_proposal_loss", 0.02),
    ("time_smoothness_proposal_loss", 1.0),
    ("sparse_transients_proposal_loss", 0.001),
    ("depth_loss", 0.05),
)

model_configs: Dict[str, Any] = {
    # dynamic K-Planes, the fork's default method
    "k-planes": kplanes_model.Config(
        eval_num_rays_per_chunk=1 << 15,
        multiscale_res=(1, 2, 4, 8, 16),
        spacetime_resolution=(64, 64, 64, 100),
        feature_dim=32,
        concat_features_across_scales=True,
        disable_viewing_dependent=True,
        proposal_net_args_list=(
            {"feature_dim": 8, "resolution": (128, 128, 128, 100)},
            {"feature_dim": 8, "resolution": (256, 256, 256, 100)},
        ),
        sigma_net_layers=1,
        sigma_net_hidden_dim=128,
        rgb_net_layers=2,
        rgb_net_hidden_dim=64,
        num_proposal_samples_per_ray=(256, 128),
        num_nerf_samples_per_ray=64,
        bounded=True,
        loss_coefficients=_KPLANES_LOSS_COEF,
        depth_sigma=0.01,
        is_euclidean_depth=False,
    ),
    # the upstream default method: static hash grids, 16 levels of 2
    # features up to 2048 behind proposal fields of 5 levels up to 128, 256
    "nerfacto": nerfacto_model.Config(eval_num_rays_per_chunk=1 << 15),
    # the fork's truncated NeRFPlayer: temporal hash grids (16 levels of 2
    # features + 64 temporal channels to 1024 at 2^19 rows, proposal grids
    # of 5 levels + 32 temporal channels to 64 and 256), the scene box as
    # collider
    "nerfplayer-nerfacto": npn_model.Config(
        disable_scene_contraction=True,
        eval_num_rays_per_chunk=1 << 15,
        log2_hashmap_size=19,
        temporal_dim=64,
        temporal_tv_weight=1.0,
    ),
    # the occupancy-grid methods: upstream instant-NGP (static zline grid of
    # 16 levels x 2 to 2048 at 2^19 rows, unbounded-sphere contraction, 24
    # samples of 256 probes over a 128^3 grid, a random background) ...
    "instant-ngp": ingp_model.Config(eval_num_rays_per_chunk=8192),
    # ... the fork's bounded version (the scene box's normalisation, 48
    # samples at a 0.001 step, a black background) ...
    "instant-ngp-bounded": ingp_model.Config(
        eval_num_rays_per_chunk=8192,
        contraction_type="aabb",
        render_step_size=0.001,
        max_num_samples_per_ray=48,
        near_plane=0.01,
        background_color="black",
    ),
    # ... and NeRFPlayer on the NGP backbone (a temporal xor grid of 16
    # levels x (2 + 64 temporal channels) to 2048 at 2^17 rows,
    # view-independent, a random train and a white eval background)
    "nerfplayer-ngp": npngp_model.Config(
        eval_num_rays_per_chunk=8192,
        contraction_type="aabb",
        render_step_size=0.001,
        max_num_samples_per_ray=48,
        near_plane=0.01,
        temporal_tv_weight=0.05,
    ),
    # the full NeRFPlayer, a static / deforming / new decomposition: a
    # deformation MLP, a static zline grid read at the point and at the
    # deformed point, temporal newness and decomposition grids (16 levels x
    # (2 + 64 temporal channels) to 1024 at 2^18 rows), view-independent,
    # nerfplayer-nerfacto's proposal grids and the scene box as collider
    "nerfplayer": np_model.Config(
        disable_scene_contraction=True,
        eval_num_rays_per_chunk=1 << 15,
        log2_hashmap_size=18,
        temporal_dim=64,
        depth_weight=0.0,
        depth_sigma=0.01,
        prob_reg_loss_mult=0.1,
        distortion_loss_mult=0.001,
        temporal_tv_weight=1.0,
    ),
    # ... and the same field (at 2^17 rows) behind nerfplayer-ngp's
    # occupancy-grid sampler
    "nerfplayer-ngp-complete": npngpc_model.Config(
        eval_num_rays_per_chunk=8192,
        contraction_type="aabb",
        render_step_size=0.001,
        max_num_samples_per_ray=48,
        near_plane=0.01,
        temporal_tv_weight=0.05,
    ),
}

# method -> the model module's name in models/__init__.py
model_names: Dict[str, str] = {"k-planes": "kplanes", "nerfacto": "nerfacto",
                               "nerfplayer-nerfacto": "nerfplayer_nerfacto",
                               "instant-ngp": "instant_ngp",
                               "instant-ngp-bounded": "instant_ngp",
                               "nerfplayer-ngp": "nerfplayer_ngp",
                               "nerfplayer": "nerfplayer",
                               "nerfplayer-ngp-complete": "nerfplayer_ngp_complete"}

# {group: {"optimizer": ..., "scheduler": ...}} per method, the groups being
# the top-level keys of the params
_KPLANES_GROUP = {
    "optimizer": AdamOptimizerConfig(lr=1e-2, eps=1e-12,
                                     moment_dtype="bfloat16"),
    "scheduler": CosineDecaySchedulerConfig(
        warm_up_end=512, max_steps=30000, learning_rate_alpha=0
    ),
}
_NERFPLAYER_GROUP = {
    "optimizer": AdamOptimizerConfig(lr=1e-2, eps=1e-12),
    "scheduler": CosineDecaySchedulerConfig(
        warm_up_end=512, max_steps=30000, learning_rate_alpha=0
    ),
}
_NERFPLAYER_FULL_GROUP = {
    "optimizer": AdamOptimizerConfig(lr=1e-2, eps=1e-6),
    "scheduler": CosineDecaySchedulerConfig(
        warm_up_end=512, max_steps=30000, learning_rate_alpha=0
    ),
}
_NGP_GROUP = {"optimizer": AdamOptimizerConfig(lr=1e-2, eps=1e-15),
              "scheduler": None}
optimizer_configs: Dict[str, Dict[str, dict]] = {
    "k-planes": {"proposal_networks": _KPLANES_GROUP, "fields": _KPLANES_GROUP},
    "nerfacto": {
        "proposal_networks": {
            "optimizer": AdamOptimizerConfig(lr=1e-2, eps=1e-15),
            "scheduler": None,
        },
        "fields": {
            "optimizer": AdamOptimizerConfig(lr=1e-2, eps=1e-15),
            "scheduler": None,
        },
        "camera_opt": {
            "optimizer": AdamOptimizerConfig(lr=6e-4, eps=1e-8, weight_decay=1e-2),
            "scheduler": None,
        },
    },
    "nerfplayer-nerfacto": {"proposal_networks": _NERFPLAYER_GROUP,
                            "fields": _NERFPLAYER_GROUP},
    "instant-ngp": {"fields": _NGP_GROUP},
    "instant-ngp-bounded": {"fields": _NGP_GROUP},
    "nerfplayer-ngp": {"fields": {
        "optimizer": AdamOptimizerConfig(lr=1e-2, eps=1e-12), "scheduler": None}},
    "nerfplayer": {"proposal_networks": _NERFPLAYER_FULL_GROUP,
                   "fields": _NERFPLAYER_FULL_GROUP},
    "nerfplayer-ngp-complete": {"fields": {
        "optimizer": AdamOptimizerConfig(lr=1e-2, eps=1e-12), "scheduler": None}},
}

camera_optimizer_configs: Dict[str, CameraOptimizerConfig] = {
    "k-planes": CameraOptimizerConfig(mode="off"),
    "nerfacto": CameraOptimizerConfig(mode="SO3xR3"),
    "nerfplayer-nerfacto": CameraOptimizerConfig(mode="off"),
    "instant-ngp": CameraOptimizerConfig(mode="off"),
    "instant-ngp-bounded": CameraOptimizerConfig(mode="off"),
    "nerfplayer-ngp": CameraOptimizerConfig(mode="off"),
    "nerfplayer": CameraOptimizerConfig(mode="off"),
    "nerfplayer-ngp-complete": CameraOptimizerConfig(mode="off"),
}

train_num_rays_per_batch: Dict[str, int] = {
    "k-planes": 4096, "nerfacto": 4096, "nerfplayer-nerfacto": 4096,
    "instant-ngp": 8192, "instant-ngp-bounded": 8192, "nerfplayer-ngp": 8192,
    "nerfplayer": 4096, "nerfplayer-ngp-complete": 8192}
