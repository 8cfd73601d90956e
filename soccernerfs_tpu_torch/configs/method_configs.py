"""Configs of the registered methods the port runs (counterpart of
soccernerfs_tpu/configs/method_configs.py; the values are copied): the
model and its registry name, the per-group optimizers and schedules, the
camera optimizer, the rays per train batch, and ``trainer_configs``, the
whole ``TrainerConfig`` of each method built from those tables.
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
    SemanticDataManagerConfig,
    VanillaDataManagerConfig,
)
from soccernerfs_tpu_torch.data.dataparsers.blender import BlenderDataParserConfig
from soccernerfs_tpu_torch.data.dataparsers.dnerf import DNeRFDataParserConfig
from soccernerfs_tpu_torch.data.dataparsers.nerfstudio import NerfstudioDataParserConfig
from soccernerfs_tpu_torch.data.dataparsers.sitcoms3d import Sitcoms3DDataParserConfig
from soccernerfs_tpu_torch.data.dataparsers.soccer import StadiumDataParserConfig
from soccernerfs_tpu_torch.engine.optimizers import (
    AdamOptimizerConfig,
    RAdamOptimizerConfig,
)
from soccernerfs_tpu_torch.engine.schedulers import (
    CosineDecaySchedulerConfig,
    ExponentialDecaySchedulerConfig,
)
from soccernerfs_tpu_torch.models import depth_nerfacto as dn_model
from soccernerfs_tpu_torch.models import instant_ngp as ingp_model
from soccernerfs_tpu_torch.models import kplanes as kplanes_model
from soccernerfs_tpu_torch.models import mipnerf as mipnerf_model
from soccernerfs_tpu_torch.models import nerfacto as nerfacto_model
from soccernerfs_tpu_torch.models import nerfplayer as np_model
from soccernerfs_tpu_torch.models import nerfplayer_nerfacto as npn_model
from soccernerfs_tpu_torch.models import nerfplayer_ngp as npngp_model
from soccernerfs_tpu_torch.models import nerfplayer_ngp_complete as npngpc_model
from soccernerfs_tpu_torch.models import neus as neus_model
from soccernerfs_tpu_torch.models import semantic_nerfw as semantic_model
from soccernerfs_tpu_torch.models import tensorf as tensorf_model
from soccernerfs_tpu_torch.models import vanilla_nerf as vnerf_model

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
    # nerfacto with the DS-NeRF depth loss on every level, its sigma
    # decaying from 0.2 to 0.01
    "depth-nerfacto": dn_model.Config(eval_num_rays_per_chunk=1 << 15),
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
    # the classic methods: NeRF's coarse and fine 8 x 256 MLPs (64 + 128
    # samples between planes at 2 and 6) ...
    "vanilla-nerf": vnerf_model.Config(),
    # ... which dnerf runs on D-NeRF data (no temporal distortion) ...
    "dnerf": vnerf_model.Config(),
    # ... mip-NeRF's one field over integrated encodings (128 + 128) ...
    "mipnerf": mipnerf_model.Config(eval_num_rays_per_chunk=1024),
    # ... and TensoRF's VM tables (16 density and 48 colour components)
    # upsampled from 128 to 300 over steps 2000-7000, 200 + 50 samples
    "tensorf": tensorf_model.Config(),
    # nerfacto with a semantic head (geo features -> 64 x 1 -> 100 classes)
    # on Sitcoms3D's panoptic labels
    "semantic-nerfw": semantic_model.Config(eval_num_rays_per_chunk=1 << 16),
    # NeuS: an 8 x 256 SDF MLP behind 64 uniform samples and 4 upsampling
    # steps of 16, the eikonal loss
    "neus": neus_model.Config(eval_num_rays_per_chunk=1024),
}

# method -> the model module's name in models/__init__.py
model_names: Dict[str, str] = {"k-planes": "kplanes",
                               "k-planes-static": "kplanes",
                               "nerfacto": "nerfacto",
                               "depth-nerfacto": "depth_nerfacto",
                               "nerfplayer-nerfacto": "nerfplayer_nerfacto",
                               "instant-ngp": "instant_ngp",
                               "instant-ngp-bounded": "instant_ngp",
                               "nerfplayer-ngp": "nerfplayer_ngp",
                               "nerfplayer": "nerfplayer",
                               "nerfplayer-ngp-complete": "nerfplayer_ngp_complete",
                               "vanilla-nerf": "vanilla_nerf",
                               "dnerf": "vanilla_nerf",
                               "mipnerf": "mipnerf",
                               "tensorf": "tensorf",
                               "semantic-nerfw": "semantic_nerfw",
                               "neus": "neus"}

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
_RADAM_GROUPS = {"fields": {"optimizer": RAdamOptimizerConfig(lr=5e-4, eps=1e-08),
                             "scheduler": None}}
_NERFACTO_GROUPS = {
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
}
_SEMANTIC_GROUPS = {name: {"optimizer": AdamOptimizerConfig(lr=1e-2, eps=1e-15),
                           "scheduler": None}
                    for name in ("proposal_networks", "fields")}
optimizer_configs: Dict[str, Dict[str, dict]] = {
    "k-planes": {"proposal_networks": _KPLANES_GROUP, "fields": _KPLANES_GROUP},
    "k-planes-static": {"proposal_networks": _KPLANES_STATIC_GROUP,
                        "fields": _KPLANES_STATIC_GROUP},
    "nerfacto": _NERFACTO_GROUPS,
    "depth-nerfacto": _NERFACTO_GROUPS,
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
    "vanilla-nerf": _RADAM_GROUPS,
    "dnerf": _RADAM_GROUPS,
    "mipnerf": _RADAM_GROUPS,
    "tensorf": {
        "fields": {
            "optimizer": AdamOptimizerConfig(lr=0.001),
            "scheduler": ExponentialDecaySchedulerConfig(lr_final=0.0001,
                                                         max_steps=30000),
        },
        "encodings": {
            "optimizer": AdamOptimizerConfig(lr=0.02),
            "scheduler": ExponentialDecaySchedulerConfig(lr_final=0.002,
                                                         max_steps=30000),
        },
    },
    "semantic-nerfw": _SEMANTIC_GROUPS,
    "neus": {"fields": {
        "optimizer": AdamOptimizerConfig(lr=5e-4, eps=1e-15),
        "scheduler": CosineDecaySchedulerConfig(
            warm_up_end=500, learning_rate_alpha=0.05, max_steps=300000)}},
}

camera_optimizer_configs: Dict[str, CameraOptimizerConfig] = {
    "k-planes": CameraOptimizerConfig(mode="off"),
    "k-planes-static": CameraOptimizerConfig(mode="off"),
    "nerfacto": CameraOptimizerConfig(mode="SO3xR3"),
    "depth-nerfacto": CameraOptimizerConfig(mode="SO3xR3"),
    "nerfplayer-nerfacto": CameraOptimizerConfig(mode="off"),
    "instant-ngp": CameraOptimizerConfig(mode="off"),
    "instant-ngp-bounded": CameraOptimizerConfig(mode="off"),
    "nerfplayer-ngp": CameraOptimizerConfig(mode="off"),
    "nerfplayer": CameraOptimizerConfig(mode="off"),
    "nerfplayer-ngp-complete": CameraOptimizerConfig(mode="off"),
    "vanilla-nerf": CameraOptimizerConfig(mode="off"),
    "dnerf": CameraOptimizerConfig(mode="off"),
    "mipnerf": CameraOptimizerConfig(mode="off"),
    "tensorf": CameraOptimizerConfig(mode="off"),
    "semantic-nerfw": CameraOptimizerConfig(mode="off"),
    "neus": CameraOptimizerConfig(mode="off"),
}

train_num_rays_per_batch: Dict[str, int] = {
    "k-planes": 4096, "k-planes-static": 8192, "nerfacto": 4096,
    "depth-nerfacto": 4096, "nerfplayer-nerfacto": 4096,
    "instant-ngp": 8192, "instant-ngp-bounded": 8192, "nerfplayer-ngp": 8192,
    "nerfplayer": 4096, "nerfplayer-ngp-complete": 8192,
    "vanilla-nerf": 1024, "dnerf": 1024, "mipnerf": 1024, "tensorf": 4096,
    "semantic-nerfw": 4096, "neus": 1024}


def _trainer(method: str, datamanager, *, dynamic_batch: bool = False,
             mixed_precision: bool = True, **trainer) -> TrainerConfig:
    """A method's TrainerConfig from the tables above."""
    return TrainerConfig(
        method_name=method,
        mixed_precision=mixed_precision,
        pipeline=PipelineConfig(
            datamanager=datamanager,
            model_name=model_names[method],
            model=model_configs[method],
            dynamic_batch=dynamic_batch,
        ),
        optimizers=optimizer_configs[method],
        **trainer,
    )


def _dynamic(method: str, dataparser=None, **datamanager
             ) -> DynamicDataManagerConfig:
    return DynamicDataManagerConfig(
        dataparser=dataparser or StadiumDataParserConfig(),
        train_num_rays_per_batch=train_num_rays_per_batch[method],
        camera_optimizer=camera_optimizer_configs[method],
        **datamanager,
    )


def _vanilla(method: str, dataparser=None, **datamanager
             ) -> VanillaDataManagerConfig:
    return VanillaDataManagerConfig(
        dataparser=dataparser or NerfstudioDataParserConfig(),
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
    "depth-nerfacto": _trainer(
        "depth-nerfacto",
        _dynamic("depth-nerfacto", NerfstudioDataParserConfig(),
                 eval_num_rays_per_batch=4096, use_importance_sampling=False),
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
    "vanilla-nerf": _trainer(
        "vanilla-nerf", _vanilla("vanilla-nerf", BlenderDataParserConfig()),
        mixed_precision=False, vis="viewer"),
    "dnerf": _trainer(
        "dnerf", _vanilla("dnerf", DNeRFDataParserConfig()),
        mixed_precision=False, vis="viewer"),
    "mipnerf": _trainer("mipnerf", _vanilla("mipnerf"), mixed_precision=False,
                        vis="viewer"),
    "tensorf": _trainer(
        "tensorf",
        _vanilla("tensorf", BlenderDataParserConfig(),
                 eval_num_rays_per_batch=4096),
        mixed_precision=False, max_num_iterations=30000,
        viewer=ViewerConfig(num_rays_per_chunk=1 << 15), vis="viewer"),
    "semantic-nerfw": _trainer(
        "semantic-nerfw",
        SemanticDataManagerConfig(
            dataparser=Sitcoms3DDataParserConfig(),
            train_num_rays_per_batch=train_num_rays_per_batch["semantic-nerfw"],
            eval_num_rays_per_batch=8192,
            camera_optimizer=camera_optimizer_configs["semantic-nerfw"]),
        steps_per_eval_batch=500, steps_per_save=2000,
        max_num_iterations=30000,
        viewer=ViewerConfig(num_rays_per_chunk=1 << 16), vis="viewer"),
    "neus": _trainer(
        "neus", _vanilla("neus", eval_num_rays_per_batch=1024),
        mixed_precision=False, steps_per_eval_batch=500, steps_per_save=2000,
        max_num_iterations=100000,
        viewer=ViewerConfig(num_rays_per_chunk=1 << 12), vis="viewer"),
}

# what `snt-train --help` prints beside each method
descriptions: Dict[str, str] = {
    "k-planes": "Dynamic NeRF on multiscale feature planes (fork default).",
    "k-planes-static": "Static 3-plane K-Planes with ISG sampling.",
    "nerfacto": "Hash-grid NeRF with proposal sampling (upstream default).",
    "depth-nerfacto": "Nerfacto with DS-NeRF depth supervision.",
    "nerfplayer-nerfacto": "Temporal hash field on the nerfacto backbone.",
    "nerfplayer": "Full NeRFPlayer: static/deform/new decomposition (fork).",
    "nerfplayer-ngp": "NeRFPlayer with occupancy-grid NGP backbone.",
    "instant-ngp": "Occupancy-grid volumetric NeRF (upstream).",
    "instant-ngp-bounded": "Instant-NGP tuned for bounded dynamic scenes (fork).",
    "nerfplayer-ngp-complete":
        "NGP backbone with the full static/deform/new decomposition (fork).",
    "vanilla-nerf": "Original NeRF with coarse/fine MLPs.",
    "mipnerf": "mip-NeRF with integrated positional encoding.",
    "tensorf": "TensoRF factorized-grid NeRF with coarse-to-fine upsampling.",
    "dnerf": "Vanilla NeRF on the D-NeRF dynamic blender format.",
    "semantic-nerfw": "Nerfacto with a semantic segmentation head (Sitcoms3D).",
    "neus": "NeuS SDF surface reconstruction with eikonal regularization.",
}
