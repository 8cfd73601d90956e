"""Configs of the registered methods the port runs (counterpart of
soccernerfs_tpu/configs/method_configs.py; the values are copied): the
model and its registry name, the per-group optimizers and schedules, the
camera optimizer, the rays per train batch, and ``trainer_configs``, the
whole ``TrainerConfig`` of each method built from those tables.

The JAX registry's nerfacto and instant-ngp read ``nerfstudio-data``,
which the port has no parser for: their entries carry no dataparser, and
a caller sets one of ``data.dataparsers.DATAPARSERS``.
"""
from __future__ import annotations

from typing import Any, Dict

from soccernerfs_tpu_torch.configs.base import (
    PipelineConfig,
    TrainerConfig,
    ViewerConfig,
)
from soccernerfs_tpu_torch.core.camera_optimizer import CameraOptimizerConfig
from soccernerfs_tpu_torch.data.datamanager import (
    DynamicDataManagerConfig,
    VanillaDataManagerConfig,
)
from soccernerfs_tpu_torch.data.dataparsers.soccer import StadiumDataParserConfig
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
    # static K-Planes: three space planes per scale, an ISG-sampled
    # datamanager (trainer_configs)
    "k-planes-static": kplanes_model.Config(
        eval_num_rays_per_chunk=1 << 16,
        multiscale_res=(1, 2, 4, 8, 16),
        spacetime_resolution=(64, 64, 64),
        feature_dim=32,
        concat_features_across_scales=True,
        disable_viewing_dependent=True,
        proposal_net_args_list=(
            {"feature_dim": 8, "resolution": (128, 128, 128)},
            {"feature_dim": 8, "resolution": (256, 256, 256)},
        ),
        sigma_net_layers=1,
        sigma_net_hidden_dim=64,
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
model_names: Dict[str, str] = {"k-planes": "kplanes",
                               "k-planes-static": "kplanes",
                               "nerfacto": "nerfacto",
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
_KPLANES_STATIC_GROUP = {
    "optimizer": AdamOptimizerConfig(lr=1e-2, eps=1e-8,
                                     moment_dtype="bfloat16"),
    "scheduler": CosineDecaySchedulerConfig(
        warm_up_end=512, max_steps=20000, learning_rate_alpha=0
    ),
}
optimizer_configs: Dict[str, Dict[str, dict]] = {
    "k-planes": {"proposal_networks": _KPLANES_GROUP, "fields": _KPLANES_GROUP},
    "k-planes-static": {"proposal_networks": _KPLANES_STATIC_GROUP,
                        "fields": _KPLANES_STATIC_GROUP},
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
    "k-planes-static": CameraOptimizerConfig(mode="off"),
    "nerfacto": CameraOptimizerConfig(mode="SO3xR3"),
    "nerfplayer-nerfacto": CameraOptimizerConfig(mode="off"),
    "instant-ngp": CameraOptimizerConfig(mode="off"),
    "instant-ngp-bounded": CameraOptimizerConfig(mode="off"),
    "nerfplayer-ngp": CameraOptimizerConfig(mode="off"),
    "nerfplayer": CameraOptimizerConfig(mode="off"),
    "nerfplayer-ngp-complete": CameraOptimizerConfig(mode="off"),
}

train_num_rays_per_batch: Dict[str, int] = {
    "k-planes": 4096, "k-planes-static": 8192, "nerfacto": 4096, "nerfplayer-nerfacto": 4096,
    "instant-ngp": 8192, "instant-ngp-bounded": 8192, "nerfplayer-ngp": 8192,
    "nerfplayer": 4096, "nerfplayer-ngp-complete": 8192}


def _trainer(method: str, datamanager, *, dynamic_batch: bool = False,
             **trainer) -> TrainerConfig:
    """A method's TrainerConfig from the tables above."""
    return TrainerConfig(
        method_name=method,
        mixed_precision=True,
        pipeline=PipelineConfig(
            datamanager=datamanager,
            model_name=model_names[method],
            model=model_configs[method],
            dynamic_batch=dynamic_batch,
        ),
        optimizers=optimizer_configs[method],
        **trainer,
    )


def _dynamic(method: str, **datamanager) -> DynamicDataManagerConfig:
    return DynamicDataManagerConfig(
        dataparser=StadiumDataParserConfig(),
        train_num_rays_per_batch=train_num_rays_per_batch[method],
        camera_optimizer=camera_optimizer_configs[method],
        **datamanager,
    )


def _vanilla(method: str, **datamanager) -> VanillaDataManagerConfig:
    return VanillaDataManagerConfig(
        train_num_rays_per_batch=train_num_rays_per_batch[method],
        camera_optimizer=camera_optimizer_configs[method],
        **datamanager,
    )


# the fork's temporal methods with IST sampling
_TEMPORAL_IST = dict(eval_num_rays_per_batch=1024,
                     train_num_images_to_sample_from=3000,
                     train_num_times_to_repeat_images=1000,
                     eval_num_images_to_sample_from=50,
                     eval_num_times_to_repeat_images=5000,
                     use_importance_sampling=True, isg=False,
                     iters_to_start_is=3000)
_SPARSE_EVAL = dict(steps_per_eval_batch=1000, steps_per_eval_image=500,
                    steps_per_eval_all_images=0)

trainer_configs: Dict[str, TrainerConfig] = {
    "k-planes": _trainer(
        "k-planes",
        _dynamic("k-planes", eval_num_rays_per_batch=512,
                 train_num_images_to_sample_from=2500,
                 train_num_times_to_repeat_images=1000,
                 eval_num_images_to_sample_from=100,
                 eval_num_times_to_repeat_images=5000,
                 use_importance_sampling=True, is_pixel_ratio=0.15, isg=False,
                 ist_range=1.0, isg_gamma=5e-2, iters_to_start_is=2000),
        steps_per_eval_batch=1000, steps_per_save=10000,
        save_only_latest_checkpoint=False, steps_per_eval_all_images=100000,
        steps_per_eval_image=500, max_num_iterations=30000,
        viewer=ViewerConfig(num_rays_per_chunk=1 << 16), vis="wandb"),
    "k-planes-static": _trainer(
        "k-planes-static",
        _dynamic("k-planes-static", eval_num_rays_per_batch=1024,
                 train_num_images_to_sample_from=1000,
                 train_num_times_to_repeat_images=2000,
                 eval_num_images_to_sample_from=50,
                 eval_num_times_to_repeat_images=5000,
                 use_importance_sampling=True, is_pixel_ratio=0.15, isg=True,
                 ist_range=0.25, iters_to_start_is=2000),
        steps_per_eval_batch=1000, steps_per_save=5000,
        save_only_latest_checkpoint=False, steps_per_eval_all_images=100000,
        steps_per_eval_image=500, max_num_iterations=20000,
        viewer=ViewerConfig(num_rays_per_chunk=1 << 16), vis="wandb"),
    "nerfacto": _trainer(
        "nerfacto", _vanilla("nerfacto", eval_num_rays_per_batch=4096),
        steps_per_eval_batch=500, steps_per_save=2000,
        max_num_iterations=30000,
        viewer=ViewerConfig(num_rays_per_chunk=1 << 15), vis="viewer"),
    "nerfplayer-nerfacto": _trainer(
        "nerfplayer-nerfacto",
        _dynamic("nerfplayer-nerfacto", is_pixel_ratio=0.15, ist_range=1.0,
                 **_TEMPORAL_IST),
        steps_per_save=10000, save_only_latest_checkpoint=False,
        max_num_iterations=30000, viewer=ViewerConfig(num_rays_per_chunk=65536),
        vis="wandb", **_SPARSE_EVAL),
    "nerfplayer": _trainer(
        "nerfplayer",
        _dynamic("nerfplayer", is_pixel_ratio=0.1, ist_range=0.25,
                 **_TEMPORAL_IST),
        steps_per_save=10000, save_only_latest_checkpoint=False,
        max_num_iterations=30000, viewer=ViewerConfig(num_rays_per_chunk=64000),
        vis="wandb", **_SPARSE_EVAL),
    "nerfplayer-ngp": _trainer(
        "nerfplayer-ngp",
        _dynamic("nerfplayer-ngp", eval_num_rays_per_batch=4096,
                 train_num_images_to_sample_from=500,
                 train_num_times_to_repeat_images=2000,
                 eval_num_images_to_sample_from=50,
                 eval_num_times_to_repeat_images=5000,
                 use_importance_sampling=True),
        dynamic_batch=True, steps_per_save=5000, max_num_iterations=30000,
        viewer=ViewerConfig(num_rays_per_chunk=64000), vis="viewer",
        **_SPARSE_EVAL),
    "instant-ngp": _trainer(
        "instant-ngp", _vanilla("instant-ngp"), dynamic_batch=True,
        steps_per_eval_batch=500, steps_per_save=2000,
        max_num_iterations=30000,
        viewer=ViewerConfig(num_rays_per_chunk=64000), vis="viewer"),
    "instant-ngp-bounded": _trainer(
        "instant-ngp-bounded",
        _dynamic("instant-ngp-bounded", use_importance_sampling=True),
        dynamic_batch=True, steps_per_eval_batch=500, steps_per_save=2000,
        max_num_iterations=30000,
        viewer=ViewerConfig(num_rays_per_chunk=64000), vis="viewer"),
    "nerfplayer-ngp-complete": _trainer(
        "nerfplayer-ngp-complete",
        _dynamic("nerfplayer-ngp-complete", eval_num_rays_per_batch=4096,
                 use_importance_sampling=True),
        dynamic_batch=True, steps_per_save=5000, max_num_iterations=30000,
        viewer=ViewerConfig(num_rays_per_chunk=64000), vis="viewer",
        **_SPARSE_EVAL),
}
