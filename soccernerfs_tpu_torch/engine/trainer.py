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

``Trainer`` (the JAX package's ``Trainer``, on one device) drives a
``TrainStep`` from a ``TrainerConfig``: the datamanager (parser, image
cache with importance weights, pixel sampler), seeded initial params,
per-step draws from a generator seeded by (seed, step), the train loop's
cadence (logs, eval batches and images, checkpoints), ``dynamic_batch``
and resume from ``load_dir``.
"""
from __future__ import annotations

import functools
import operator
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from soccernerfs_tpu_torch.core.camera_optimizer import (
    CameraOptimizerConfig,
    apply_camera_optimizer,
    init_camera_optimizer,
)
from soccernerfs_tpu_torch.configs.base import TrainerConfig
from soccernerfs_tpu_torch.convert import params_from_jax, seeded_params
from soccernerfs_tpu_torch.core.cameras import Cameras, generate_rays
from soccernerfs_tpu_torch.engine import checkpoints
from soccernerfs_tpu_torch.engine.optimizers import (
    AdamOptimizerConfig,
    AdamState,
    adam_init,
    adam_update,
    schedule_fn,
)
from soccernerfs_tpu_torch.engine.render import render_camera
from soccernerfs_tpu_torch.models import get_model
from soccernerfs_tpu_torch.ops.kernels import scatter_kernels
from soccernerfs_tpu_torch.utils import writer
from soccernerfs_tpu_torch.utils.device import resolve_device
from soccernerfs_tpu_torch.utils.tree import tree_leaves
from soccernerfs_tpu_torch.utils.writer import EventName


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

    @torch.no_grad()
    def eval_losses(self, state: TrainState, batch: Dict[str, torch.Tensor],
                    cameras: Cameras, generator: torch.Generator) -> dict:
        """The loss dict and metrics of a batch of ``cameras`` (the eval
        split's) under the training forward, its draws from ``generator``,
        at the state's params and model state; no gradient."""
        cfg, model = self.cfg, self.model
        draws = model.train_draws(cfg, batch["cam_idx"].shape[0], generator,
                                  self.device)
        rays = generate_rays(cameras, batch["cam_idx"], batch["coords"])
        outputs = model.get_outputs(
            cfg, state.params, self.aabb, rays, train=True,
            jitters=draws["jitters"], background=draws["background"],
            **(model.schedules(cfg, state.step, state.aux)
               if hasattr(model, "schedules") else {}))
        metrics = model.get_metrics_dict(cfg, outputs, batch)
        loss_dict = model.get_loss_dict(
            cfg, state.params, outputs, batch, metrics,
            **({} if draws.get("tv_rows") is None
               else {"tv_rows": draws["tv_rows"]}))
        return {**loss_dict, **metrics}

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


def step_check(step: int, interval: int, run_at_zero: bool = False) -> bool:
    """Whether a cadence of ``interval`` steps fires at ``step`` (never for
    interval 0)."""
    if interval == 0:
        return False
    return (run_at_zero or step != 0) and step % interval == 0


def step_seed(seed: int, step: int) -> int:
    """A generator seed of (seed, step): the counterpart of
    ``fold_in(PRNGKey(seed), step)``, so a resumed run draws at a step what
    an uninterrupted one draws there."""
    state = np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)
    return int(state[0] >> np.uint64(1))


def dynamic_batch_update(cur: int, num_samples: float, target_samples: int,
                         base_rays: int, ema_lg: Optional[float]
                         ) -> Tuple[int, float]:
    """The rays per batch after a step that drew ``num_samples`` samples
    with ``cur`` rays, and the new EMA of log2(desired rays).

    The JAX trainer's rule: scale toward ``target_samples`` samples per
    batch, in powers of two between 64 and 4 * ``base_rays``, moving only
    when the EMA (0.7 old, 0.3 new) sits more than 0.75 octave from the
    current size."""
    desired = cur * target_samples / max(num_samples, 1.0)
    lg = float(np.log2(desired))
    ema_lg = lg if ema_lg is None else 0.7 * ema_lg + 0.3 * lg
    bucket = int(2 ** np.clip(np.round(ema_lg), 6, np.log2(base_rays * 4)))
    if bucket != cur and abs(ema_lg - np.log2(cur)) > 0.75:
        return bucket, ema_lg
    return cur, ema_lg


class Trainer:
    """Training from a ``TrainerConfig`` on one device.

    Args:
        config: the method's config (``configs/method_configs.trainer_configs``
            with a dataparser from ``data.dataparsers.DATAPARSERS``).
        test_mode: "val" (a training run: writes its config, the
            dataparser's transform and the writers' output), "test" or
            "inference" (evaluates the eval split's "test" images).
        device: default CUDA; raises when CUDA is absent and the caller
            did not ask for another device.

    Wherever the loop reads a step's values on the host, and before every
    checkpoint, it calls ``scatter_kernels.raise_if_out_of_range``: a
    hash-grid step's table gradient is trusted only after that check.
    """

    def __init__(self, config: TrainerConfig, test_mode: str = "val",
                 device=None):
        config.machine.check_single_device()
        self.config = config
        self.test_mode = test_mode
        self.device = resolve_device(device)
        self.base_dir = config.get_base_dir()
        self.model = get_model(config.pipeline.model_name)
        self.model_cfg = config.pipeline.model
        if hasattr(self.model, "host_update"):
            raise NotImplementedError(
                f"model {config.pipeline.model_name!r} reshapes its params on "
                f"the host (host_update), which the trainer does not support")
        config.seed_everything()

    def setup(self) -> "Trainer":
        """The datamanager, the initial params (``seeded_params`` of
        ``machine.seed``), the train step and its state; resumes from
        ``load_dir`` when set."""
        config = self.config
        self.datamanager = config.pipeline.datamanager.setup(
            test_mode=self.test_mode, seed=config.machine.seed,
            device=self.device)
        self.train_cameras: Cameras = self.datamanager.train_cameras
        self.eval_cameras: Cameras = self.datamanager.eval_cameras
        self.aabb = self.datamanager.train_dataparser_outputs.scene_box.aabb.to(
            self.device)
        self.num_train_data = len(self.datamanager.train_dataset)

        params = params_from_jax(
            seeded_params(self.model_cfg, config.machine.seed,
                          self.num_train_data), self.device)
        cam_opt = config.pipeline.datamanager.camera_optimizer
        opt_configs = dict(config.optimizers)
        if cam_opt.mode != "off" and "camera_opt" not in opt_configs:
            opt_configs["camera_opt"] = {
                "optimizer": AdamOptimizerConfig(lr=6e-4, eps=1e-8,
                                                 weight_decay=1e-2),
                "scheduler": None,
            }
        self.train_step = TrainStep(
            self.model_cfg, self.train_cameras, self.aabb, opt_configs,
            self.device, model=config.pipeline.model_name,
            camera_optimizer=cam_opt)
        self.state = self.train_step.init_state(params)
        self._maybe_load_checkpoint()

        if self.test_mode == "val":
            config.save_config()
            self.datamanager.train_dataparser_outputs.save_dataparser_transform(
                self.base_dir / "dataparser_transforms.json")
            writer.setup_writers(config.vis, self.base_dir, config.experiment_name)
        return self

    def _generator(self, step: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(
            step_seed(self.config.machine.seed, step))

    def _device_batch(self, raw: Dict) -> Dict[str, torch.Tensor]:
        """A sampler batch on the device: cam_idx [N] int32, coords [N, 2]
        pixel centres, image [N, 3]; copied from pinned host memory
        without waiting on a CUDA device."""
        indices = raw["indices"]
        host = {
            "cam_idx": indices[:, 0].astype(np.int32),
            "coords": indices[:, 1:].astype(np.float32) + 0.5,
            "image": raw["image"].astype(np.float32),
        }
        if "depth_image" in raw:
            host["depth_image"] = raw["depth_image"].astype(np.float32)
        pin = self.device.type == "cuda"
        return {k: (torch.from_numpy(v).pin_memory() if pin else torch.from_numpy(v))
                .to(self.device, non_blocking=pin) for k, v in host.items()}

    def train_iteration(self, step: int) -> Dict[str, torch.Tensor]:
        """One training step at ``step`` (the state's step); the returned
        values stay on the device."""
        if step != self.state.step:
            raise ValueError(f"train_iteration({step}) on a state at step "
                             f"{self.state.step}")
        raw = self.datamanager.next_train_raw(step)
        batch = self._device_batch(raw)
        return self.train_step.train_iteration(self.state, batch,
                                               self._generator(step))

    def eval_iteration(self, step: int) -> Dict[str, torch.Tensor]:
        """An eval batch's loss dict and metrics (on the device)."""
        batch = self._device_batch(self.datamanager.next_eval_raw(step))
        return self.train_step.eval_losses(
            self.state, batch, self.eval_cameras,
            self._generator(step + 1_000_000))

    def render_camera(self, cameras: Cameras, camera_index: int,
                      chunk: Optional[int] = None) -> Dict[str, np.ndarray]:
        """A whole image of ``cameras[camera_index]`` at the state's params
        (and model state), as host arrays."""
        aux = self.state.aux if hasattr(self.model, "eval_kwargs") else None
        out = render_camera(self.model_cfg, self.state.params, cameras,
                            camera_index, chunk, self.device, aabb=self.aabb,
                            model=self.config.pipeline.model_name, aux=aux)
        return {k: v.cpu().numpy() for k, v in out.items()}

    def eval_image(self, step: int) -> Dict[str, float]:
        """One eval image (the next in turn) rendered, with its PSNR."""
        idx, _, batch = self.datamanager.next_eval_image(
            step // max(self.config.steps_per_eval_image, 1))
        outputs = self.render_camera(self.eval_cameras, idx)
        gt = np.asarray(batch["image"], np.float32)
        mse = float(np.mean((outputs["rgb"] - gt) ** 2))
        psnr = -10.0 * np.log10(max(mse, 1e-12))
        writer.put_scalar(EventName.CURR_TEST_PSNR, psnr, step)
        writer.put_image("Eval Images/img",
                         np.concatenate([gt, outputs["rgb"]], axis=1), step)
        return {"psnr": psnr, "image_idx": idx}

    def eval_all_images(self, step: int) -> Dict[str, float]:
        """Mean PSNR over every eval image, and the render rate."""
        psnrs = []
        t0 = time.time()
        num_rays = 0
        for idx in range(len(self.datamanager.eval_dataset)):
            _, _, batch = self.datamanager.next_eval_image(idx)
            outputs = self.render_camera(self.eval_cameras, idx)
            gt = np.asarray(batch["image"], np.float32)
            mse = float(np.mean((outputs["rgb"] - gt) ** 2))
            psnrs.append(-10.0 * np.log10(max(mse, 1e-12)))
            num_rays += gt.shape[0] * gt.shape[1]
        dt = time.time() - t0
        metrics = {"psnr": float(np.mean(psnrs)),
                   "num_rays_per_sec": num_rays / dt, "fps": len(psnrs) / dt}
        writer.put_dict("Eval Images Metrics Dict (all images)", metrics, step)
        return metrics

    def _read(self, values: Dict[str, torch.Tensor]) -> Dict[str, float]:
        """Step values on the host, after the deferred range check."""
        out = {k: float(v) for k, v in values.items()}
        scatter_kernels.raise_if_out_of_range(self.device)
        return out

    def train(self) -> None:
        """The loop from the state's step to ``max_num_iterations``: log
        every ``steps_per_log`` steps (rolling rays/s, ETA, the loss
        dict), eval batches and images, checkpoints, ``dynamic_batch``;
        then the final checkpoint."""
        config = self.config
        start_step = self.state.step
        num_iters = config.max_num_iterations
        t_start = time.time()
        sampler = self.datamanager.train_pixel_sampler
        rays_per_batch = self.datamanager.get_train_rays_per_batch()
        base_rays = rays_per_batch
        ema_lg = None
        t_last_log = time.time()

        for step in range(start_step, num_iters):
            metrics = self.train_iteration(step)
            if config.pipeline.dynamic_batch and "num_samples_per_batch" in metrics:
                num_samples = self._read(
                    {"n": metrics["num_samples_per_batch"]})["n"]
                rays, ema_lg = dynamic_batch_update(
                    sampler.num_rays_per_batch, num_samples,
                    config.pipeline.target_num_samples, base_rays, ema_lg)
                if rays != sampler.num_rays_per_batch:
                    sampler.set_num_rays_per_batch(rays)
                rays_per_batch = sampler.num_rays_per_batch

            if step % config.logging.steps_per_log == 0:
                values = self._read(metrics)
                # the read waits for every step since the last log: the
                # interval's mean is an honest rolling rate
                now = time.time()
                interval = config.logging.steps_per_log if step != start_step else 1
                dt = (now - t_last_log) / interval
                t_last_log = now
                writer.put_scalar(EventName.TRAIN_RAYS_PER_SEC, rays_per_batch / dt,
                                  step)
                writer.put_scalar(EventName.ETA, (num_iters - step) * dt, step)
                writer.put_dict("Train Loss Dict", values, step)
                writer.put_scalar("Train Loss", values["Train Loss"], step)

            if config.steps_per_eval_batch and step_check(step, config.steps_per_eval_batch):
                writer.put_dict("Eval Loss Dict",
                                self._read(self.eval_iteration(step)), step)
            if config.steps_per_eval_image and step_check(step, config.steps_per_eval_image):
                self.eval_image(step)
            if config.steps_per_eval_all_images and step_check(
                    step, config.steps_per_eval_all_images):
                self.eval_all_images(step)
            if config.steps_per_save and step_check(step, config.steps_per_save):
                self.save_checkpoint(step)
            writer.write_out_storage()

        self.save_checkpoint(num_iters - 1)
        writer.write_out_storage()
        print(f"training finished: {num_iters - start_step} steps in "
              f"{time.time() - t_start:.1f}s")

    def save_checkpoint(self, step: int) -> Path:
        """Checkpoint the state as that of loop step ``step`` (the state's
        step is ``step + 1``)."""
        scatter_kernels.raise_if_out_of_range(self.device)
        s = self.state
        return checkpoints.save_checkpoint(self.base_dir, step, {
            "step": s.step,
            "steps_since_update": s.steps_since_update,
            "params": s.params,
            "opt_state": {name: {"count": o.count, "mu": o.mu, "nu": o.nu}
                          for name, o in s.opt_state.items()},
            "aux": s.aux,
        }, self.config.save_only_latest_checkpoint)

    def _maybe_load_checkpoint(self) -> None:
        """Resume from ``load_dir`` (its ``load_step``, else the latest)."""
        if self.config.load_dir is None:
            return
        step, saved = checkpoints.load_checkpoint(Path(self.config.load_dir),
                                                  self.config.load_step)
        dev = self.device

        def on_device(tree):
            if isinstance(tree, dict):
                return {k: on_device(v) for k, v in tree.items()}
            if isinstance(tree, list):
                return [on_device(v) for v in tree]
            return tree.to(dev)

        params = on_device(saved["params"])
        for leaf in tree_leaves(params):
            leaf.requires_grad_(True)
        self.state = TrainState(
            params=params,
            opt_state={name: AdamState(count=o["count"], mu=on_device(o["mu"]),
                                       nu=on_device(o["nu"]))
                       for name, o in saved["opt_state"].items()},
            step=saved["step"],
            steps_since_update=saved["steps_since_update"],
            aux=on_device(saved["aux"]),
        )
        print(f"resumed from checkpoint step {step}")
