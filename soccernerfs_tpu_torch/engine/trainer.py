"""One training step on one device (the counterpart of the step that
soccernerfs_tpu's ``Trainer._build_step_fns`` jits, without a mesh).

``TrainStep`` holds what does not change between steps (the model and its
config, cameras, scene box, per-group optimizer configs, the camera
optimizer's config); ``TrainState`` holds what does (params, the optimizer
state, the step, the host counter of the proposal-update schedule, and the
model's non-trainable state, such as the occupancy grid).
``train_iteration`` decides the proposal update on the host, generates the
batch's rays (through the camera optimizer's pose corrections when it is
on), runs the forward, the losses and ``backward``, applies one Adam
update per param group, then updates the model's state (``update_aux``)
from the updated params.
The batch comes from the caller in the layout of the JAX trainer's
``_device_batch``: ``cam_idx`` [N] int32, ``coords`` [N, 2] (row, col)
pixel coordinates + 0.5, ``image`` [N, 3].
"""
from __future__ import annotations

import functools
import operator
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import torch

from soccernerfs_tpu_torch.core.camera_optimizer import (
    CameraOptimizerConfig,
    apply_camera_optimizer,
    init_camera_optimizer,
)
from soccernerfs_tpu_torch.core.cameras import Cameras, generate_rays
from soccernerfs_tpu_torch.engine.optimizers import (
    AdamState,
    adam_init,
    adam_update,
    schedule_fn,
)
from soccernerfs_tpu_torch.models import get_model
from soccernerfs_tpu_torch.utils.device import resolve_device
from soccernerfs_tpu_torch.utils.tree import tree_leaves


@dataclass
class TrainState:
    params: dict                      # leaves require grad
    opt_state: Dict[str, AdamState]   # per top-level param group
    step: int = 0
    steps_since_update: int = 0       # host counter of host_static_kwargs
    aux: dict = field(default_factory=dict)  # the model's non-trainable state


class TrainStep:
    """The static half of training: model, cameras, scene box, optimizers.

    Args:
        cfg: the model config.
        cameras: the training cameras (moved to ``device``).
        aabb: [2, 3] scene box.
        optimizer_configs: {group: {"optimizer": AdamOptimizerConfig,
            "scheduler": config or None}} per top-level param group
            (configs/method_configs.py).
        device: default CUDA; raises when CUDA is absent and the caller
            did not ask for another device.
        model: the model's registry name (models/__init__.py).
        camera_optimizer: when its mode is not "off", ``init_state`` adds a
            "camera_opt" param group (one pose adjustment per training
            camera) and every step's rays go through its corrections, so
            origins, directions and sample positions carry a gradient.
    """

    def __init__(self, cfg, cameras: Cameras, aabb,
                 optimizer_configs: Dict[str, dict], device=None, *,
                 model: str = "kplanes",
                 camera_optimizer: CameraOptimizerConfig = CameraOptimizerConfig()):
        self.device = resolve_device(device)
        self.model = get_model(model)
        self.cfg = cfg
        self.camera_optimizer = camera_optimizer
        self.cameras = cameras.to(self.device)
        self.aabb = torch.as_tensor(aabb, dtype=torch.float32, device=self.device)
        self.optimizers = {
            name: (g["optimizer"],
                   schedule_fn(g.get("scheduler"), g["optimizer"].lr))
            for name, g in optimizer_configs.items()
        }

    def init_state(self, params: dict, aux: Optional[dict] = None) -> TrainState:
        """A state at step 0 over ``params`` (the model's param tree on
        this device; its leaves are made to require grad, in place).  With
        the camera optimizer on, a "camera_opt" group of zero adjustments
        joins the params unless they bring one.  The model's state is
        ``aux`` when given, else its ``init_aux`` (none for a model without
        one)."""
        if self.camera_optimizer.mode != "off" and "camera_opt" not in params:
            params["camera_opt"] = init_camera_optimizer(
                self.camera_optimizer, self.cameras.num_cameras,
                device=self.device)
        missing = [name for name in params if name not in self.optimizers]
        if missing:
            raise KeyError(f"no optimizer config for param groups {missing}")
        for leaf in tree_leaves(params):
            if leaf.device.type != self.device.type:
                raise ValueError(f"params are on {leaf.device}, training on "
                                 f"{self.device}")
            leaf.requires_grad_(True)
        if aux is None:
            aux = (self.model.init_aux(self.cfg, self.device)
                   if hasattr(self.model, "init_aux") else {})
        return TrainState(params=params, aux=aux, opt_state={
            name: adam_init(self.optimizers[name][0], tree_leaves(group))
            for name, group in params.items()
        })

    def loss_and_grads(
        self,
        state: TrainState,
        batch: Dict[str, torch.Tensor],
        *,
        train_proposal_networks: bool,
        generator: Optional[torch.Generator] = None,
        jitters: Optional[Sequence[torch.Tensor]] = None,
        background: Optional[torch.Tensor] = None,
        tv_rows: Optional[Sequence] = None,
    ):
        """Loss, loss dict, metrics and the gradient of every leaf of
        ``state.params`` (``tree_leaves`` order; None for a leaf the loss
        does not reach) at ``state.step``, before any update; the forward
        also takes the model's ``schedules`` of ``state.aux`` (an
        occupancy model's binarized grid).  The draws
        (the model's ``train_draws``: jitters, a random background, the
        temporal TV's rows) are ``jitters``/``background``/``tv_rows`` when
        any is given (those the model takes), else drawn from
        ``generator``."""
        cfg, model = self.cfg, self.model
        if jitters is None and background is None and tv_rows is None:
            draws = model.train_draws(cfg, batch["cam_idx"].shape[0],
                                      generator, self.device)
        else:
            draws = {"jitters": jitters, "background": background,
                     "tv_rows": tv_rows}
        correction = apply_camera_optimizer(
            self.camera_optimizer, state.params.get("camera_opt"),
            batch["cam_idx"])
        rays = generate_rays(self.cameras, batch["cam_idx"], batch["coords"],
                             correction)
        outputs = model.get_outputs(
            cfg, state.params, self.aabb, rays, train=True,
            anneal=model.proposal_anneal(cfg, state.step),
            train_proposal_networks=train_proposal_networks,
            jitters=draws["jitters"], background=draws["background"],
            **(model.schedules(cfg, state.step, state.aux)
               if hasattr(model, "schedules") else {}),
        )
        metrics = model.get_metrics_dict(cfg, outputs, batch)
        loss_dict = model.get_loss_dict(
            cfg, state.params, outputs, batch, metrics,
            **({} if draws.get("tv_rows") is None
               else {"tv_rows": draws["tv_rows"]}))
        loss = functools.reduce(operator.add, loss_dict.values())
        grads = torch.autograd.grad(loss, tree_leaves(state.params),
                                    allow_unused=True)
        return (loss.detach(), {k: v.detach() for k, v in loss_dict.items()},
                {k: v.detach() for k, v in metrics.items()}, list(grads))

    def apply_grads(self, state: TrainState, grads: List) -> None:
        """One optimizer update per param group, in place; step + 1."""
        i = 0
        for name, group in state.params.items():
            leaves = tree_leaves(group)
            opt, schedule = self.optimizers[name]
            adam_update(opt, schedule, state.opt_state[name], leaves,
                        grads[i:i + len(leaves)])
            i += len(leaves)
        state.step += 1

    def train_iteration(
        self,
        state: TrainState,
        batch: Dict[str, torch.Tensor],
        generator: Optional[torch.Generator] = None,
    ) -> Dict[str, torch.Tensor]:
        """One training step, in place on ``state``, its draws from
        ``generator``.  Returns {"Train Loss", **loss_dict, **metrics} as
        0-d tensors, still on the device: the step never waits for it.

        A model with ``update_aux`` then updates ``state.aux`` from the
        updated params at the step's own (pre-increment) number, its draws
        from ``generator`` too; the host decides whether the step updates
        and which update runs.

        On CUDA, ``scatter_add_rows`` (the hash grids' table gradient)
        checks its row indices without a host sync: an update outside the
        table is dropped and flagged on the device.  A caller that reads
        the loss on the host must then call
        ``ops.kernels.scatter_kernels.raise_if_out_of_range(device)``,
        which raises ``IndexError`` on such a drop, before it trusts the
        step.  This method does not read the flag: reading it waits for the
        device, and the step is to become one captured graph."""
        host = {"steps_since_update": state.steps_since_update}
        flag = self.model.host_static_kwargs(
            self.cfg, state.step, host)["train_proposal_networks"]
        state.steps_since_update = host["steps_since_update"]
        step = state.step
        loss, loss_dict, metrics, grads = self.loss_and_grads(
            state, batch, train_proposal_networks=flag, generator=generator)
        self.apply_grads(state, grads)
        if hasattr(self.model, "update_aux"):
            state.aux = self.model.update_aux(self.cfg, state.params, self.aabb,
                                              step, state.aux, generator)
        return {"Train Loss": loss, **loss_dict, **metrics}
