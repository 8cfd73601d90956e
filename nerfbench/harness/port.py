"""The system under test: ``soccernerfs_tpu_torch`` built from a
configuration's file.  Nothing else of the program is used by the
benchmark than what is built here, the ``render_camera`` entry and the
kernels' names in the trace."""
from __future__ import annotations


def model_config(cfg: dict, overrides: dict | None = None):
    """The program's model config of a configuration file (``overrides``:
    a smaller copy for the CPU tests)."""
    from soccernerfs_tpu_torch.models import get_model

    return get_model(cfg["model"]).Config(**{**cfg["config"], **(overrides or {})})


def optimizer_configs(cfg: dict) -> dict:
    from soccernerfs_tpu_torch.engine.optimizers import AdamOptimizerConfig
    from soccernerfs_tpu_torch.engine.schedulers import CosineDecaySchedulerConfig

    groups = {}
    for name, opt in cfg["optimizers"].items():
        sched = opt.get("scheduler")
        if sched is not None and sched["kind"] != "cosine":
            raise ValueError(f"scheduler kind {sched['kind']!r}")
        groups[name] = {
            "optimizer": AdamOptimizerConfig(lr=opt["lr"], eps=opt["eps"],
                                             moment_dtype=opt.get("moment_dtype")),
            "scheduler": None if sched is None else CosineDecaySchedulerConfig(
                warm_up_end=sched["warm_up_end"], max_steps=sched["max_steps"],
                learning_rate_alpha=sched["learning_rate_alpha"]),
        }
    return groups


def train_step(cfg: dict, model_cfg, cameras, device):
    """The program's ``TrainStep`` of the configuration."""
    from soccernerfs_tpu_torch.core.camera_optimizer import CameraOptimizerConfig
    from soccernerfs_tpu_torch.engine.trainer import TrainStep

    return TrainStep(model_cfg, cameras, cfg["aabb"], optimizer_configs(cfg),
                     device=device, model=cfg["model"],
                     camera_optimizer=CameraOptimizerConfig(mode=cfg["camera_optimizer"]))


def render(cfg: dict, model_cfg, params, cameras, index, device, chunk=None):
    """One whole image through the program's render entry, every output
    copied to the host, as ``Trainer.render_camera`` returns it."""
    from soccernerfs_tpu_torch.engine.render import render_camera

    out = render_camera(model_cfg, params, cameras, index, chunk, device,
                        aabb=cfg["aabb"], model=cfg["model"])
    return {k: v.cpu() for k, v in out.items()}


def release_flags(device) -> None:
    """The deferred checks a step leaves on the device (the hash grids'
    scatter range flag)."""
    from soccernerfs_tpu_torch.ops.kernels import scatter_kernels

    scatter_kernels.raise_if_out_of_range(device)


def camera(pose, time: float, cam: dict, device):
    """One pinhole camera as the program's ``Cameras``, from a [3, 4] pose:
    what a viewer request hands the render entry."""
    import numpy as np

    from soccernerfs_tpu_torch.core.cameras import Cameras

    h, w, f = cam["height"], cam["width"], cam["focal"]
    return Cameras.create(camera_to_worlds=np.asarray(pose, np.float32)[None], fx=f,
                          fy=f, cx=w / 2, cy=h / 2, width=w, height=h,
                          times=np.array([time], np.float32), device=device)
