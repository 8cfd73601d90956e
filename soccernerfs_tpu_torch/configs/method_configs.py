"""Model configs of the registered methods the port runs (counterpart of
soccernerfs_tpu/configs/method_configs.py; only the model values, copied).
"""
from __future__ import annotations

from typing import Dict

from soccernerfs_tpu_torch.models import kplanes as kplanes_model

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

model_configs: Dict[str, kplanes_model.Config] = {
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
}
