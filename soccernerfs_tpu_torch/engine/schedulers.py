"""Learning-rate schedules (counterpart of soccernerfs_tpu/engine/schedulers.py).

A schedule maps an update count to the multiplier of the base lr, in f32
arithmetic as the JAX versions compute it.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

f32 = np.float32


@dataclass(frozen=True)
class ExponentialDecaySchedulerConfig:
    """lr = lr_init * (lr_final / lr_init)^(step / max_steps), with an
    optional warmup from lr_pre_warmup."""

    lr_final: float = 5e-6
    max_steps: int = 100000
    lr_pre_warmup: float = 1e-8
    warmup_steps: int = 0
    ramp: str = "cosine"


def exponential_decay_schedule(cfg: ExponentialDecaySchedulerConfig,
                               lr_init: float):
    def schedule(step) -> np.float32:
        step = f32(step)
        if cfg.warmup_steps > 0:
            ramp = np.clip(step / f32(cfg.warmup_steps), f32(0), f32(1))
            if cfg.ramp == "cosine":
                ramp = np.sin(f32(0.5 * np.pi) * ramp)
            warmup = f32(cfg.lr_pre_warmup) + f32(lr_init - cfg.lr_pre_warmup) * ramp
        else:
            warmup = f32(lr_init)
        t = np.clip((step - f32(cfg.warmup_steps))
                    / f32(max(cfg.max_steps - cfg.warmup_steps, 1)), f32(0), f32(1))
        decayed = np.exp(f32(np.log(lr_init)) * (f32(1) - t)
                         + f32(np.log(max(cfg.lr_final, 1e-12))) * t)
        lr = warmup if step < cfg.warmup_steps else decayed
        return f32(lr / f32(lr_init))

    return schedule


@dataclass(frozen=True)
class CosineDecaySchedulerConfig:
    """Linear warmup to 1, then cosine decay to ``learning_rate_alpha``."""

    warm_up_end: int = 5000
    learning_rate_alpha: float = 0.05
    max_steps: int = 300000


def cosine_decay_schedule(cfg: CosineDecaySchedulerConfig):
    def schedule(step) -> np.float32:
        step = f32(step)
        if step < cfg.warm_up_end:
            return f32(step / f32(max(cfg.warm_up_end, 1)))
        alpha = f32(cfg.learning_rate_alpha)
        progress = np.clip((step - f32(cfg.warm_up_end))
                           / f32(max(cfg.max_steps - cfg.warm_up_end, 1)),
                           f32(0), f32(1))
        return f32((np.cos(f32(np.pi) * progress) + f32(1)) * f32(0.5)
                   * (f32(1) - alpha) + alpha)

    return schedule
