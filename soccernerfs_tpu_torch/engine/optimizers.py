"""Per-group Adam and RAdam (counterpart of
soccernerfs_tpu/engine/optimizers.py).

The JAX package chains optax transforms per top-level param group
("fields", "proposal_networks", "camera_opt", "encodings"): coupled weight
decay where set (``add_decayed_weights``), Adam with f32 moments
(``scale_by_adam``) or a low-precision first moment
(``scale_by_adam_lowp``), or RAdam (``scale_by_radam``), then
``scale_by_schedule(-lr * schedule)``.  The
port writes that chain as plain functions over a group's list of leaves
rather than as a ``torch.optim.Optimizer``: the params are the JAX
package's nested dicts and lists, the schedule counts updates from 0 as
optax's does (so the registry's warm-up makes the first update move
nothing), and zero gradients still advance the moments, which is what the
proposal sigma nets get on non-update steps.  A torch optimizer would skip
parameters without a gradient and count steps from 1.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np
import torch

from soccernerfs_tpu_torch.engine.schedulers import (
    CosineDecaySchedulerConfig,
    ExponentialDecaySchedulerConfig,
    cosine_decay_schedule,
    exponential_decay_schedule,
)

f32 = np.float32


@dataclass(frozen=True)
class AdamOptimizerConfig:
    """Adam; field names and defaults are the JAX package's.

    ``weight_decay`` is coupled L2: ``weight_decay * p`` joins the gradient
    before the moments, as torch.optim.Adam's.  ``moment_dtype`` is the
    first moment's storage type: None for f32 (the nerfacto groups),
    "bfloat16" (the k-planes groups); the second moment is stored in f32
    and all arithmetic is f32.  The JAX config's clipping and bf16 second
    moment are not ported: no registered method uses them.
    """

    lr: float = 5e-4
    eps: float = 1e-8
    weight_decay: float = 0.0
    moment_dtype: Optional[str] = None

    def __post_init__(self):
        if self.moment_dtype not in (None, "bfloat16"):
            raise ValueError(f"moment_dtype {self.moment_dtype!r} is not "
                             f"ported (None or 'bfloat16')")


@dataclass(frozen=True)
class RAdamOptimizerConfig(AdamOptimizerConfig):
    """RAdam (vanilla-nerf, dnerf, mipnerf): ``radam_update``; ``kind`` as
    the JAX config names it.  Its moments are f32."""

    kind: str = "radam"

    def __post_init__(self):
        super().__post_init__()
        if self.kind != "radam" or self.moment_dtype is not None:
            raise ValueError("RAdam keeps f32 moments (kind 'radam')")


def schedule_fn(scheduler_config, lr_init: float) -> Callable:
    """The update-count -> lr-multiplier schedule of a scheduler config
    (None: constant 1)."""
    if scheduler_config is None:
        return lambda step: f32(1.0)
    if isinstance(scheduler_config, CosineDecaySchedulerConfig):
        return cosine_decay_schedule(scheduler_config)
    if isinstance(scheduler_config, ExponentialDecaySchedulerConfig):
        return exponential_decay_schedule(scheduler_config, lr_init)
    raise TypeError(f"unknown scheduler config {scheduler_config!r}")


@dataclass
class AdamState:
    """One group's state: the count of updates made (Adam's bias
    correction of an update uses the count after it, the schedule the
    count before it), the moments."""

    count: int = 0
    mu: List[torch.Tensor] = field(default_factory=list)
    nu: List[torch.Tensor] = field(default_factory=list)


def adam_init(cfg: AdamOptimizerConfig, leaves) -> AdamState:
    mu_dtype = torch.float32 if cfg.moment_dtype is None else torch.bfloat16
    return AdamState(
        mu=[torch.zeros_like(p, dtype=mu_dtype) for p in leaves],
        nu=[torch.zeros_like(p, dtype=torch.float32) for p in leaves],
    )


@torch.no_grad()
def adam_update(cfg: AdamOptimizerConfig, schedule: Callable,
                state: AdamState, leaves, grads,
                b1: float = 0.9, b2: float = 0.999) -> None:
    """One update of a group's ``leaves`` in place, from ``grads`` (None
    for a leaf that got no gradient: a zero gradient).

    Per leaf, in f32 and in the order of optax's scale_by_adam and the JAX
    package's scale_by_adam_lowp: g += weight_decay p where set, then
    mu = b1 mu + (1-b1) g, nu = b2 nu + (1-b2) g g,
    u = (mu / c1) / (sqrt(nu / c2) + eps) with c_k = 1 - b_k^count; then
    p += u * (-lr * schedule(count - 1)).  The moments are stored back in
    their storage types.
    """
    step_size = float(f32(-cfg.lr) * f32(schedule(state.count)))
    state.count += 1
    count = f32(state.count)
    c1 = f32(1.0) - f32(b1) ** count
    c2 = f32(1.0) - f32(b2) ** count
    for p, g, mu, nu in zip(leaves, grads, state.mu, state.nu):
        g = torch.zeros_like(p) if g is None else g.float()
        if cfg.weight_decay:
            g = g + cfg.weight_decay * p
        mu_f = b1 * mu.float() + (1.0 - b1) * g
        nu_f = b2 * nu.float() + (1.0 - b2) * g * g
        upd = (mu_f / float(c1)) / (torch.sqrt(nu_f / float(c2)) + cfg.eps)
        p.add_(upd * step_size)
        mu.copy_(mu_f)
        nu.copy_(nu_f)


# optax.scale_by_radam's threshold on the SMA length rho: below it the
# update is the bias-corrected first moment alone
RADAM_THRESHOLD = 5.0


@torch.no_grad()
def radam_update(cfg: AdamOptimizerConfig, schedule: Callable,
                 state: AdamState, leaves, grads,
                 b1: float = 0.9, b2: float = 0.999) -> None:
    """One RAdam update of a group's ``leaves`` in place, in the order and
    f32 arithmetic of optax's ``scale_by_radam`` (not torch.optim.RAdam's):
    g += weight_decay p where set; mu = (1-b1) g + b1 mu, nu = (1-b2) g g +
    b2 nu; with t the count after the update, rho = rho_inf - 2 t b2^t /
    (1 - b2^t) and rho_inf = 2 / (1 - b2) - 1; mu_hat = mu / (1 - b1^t),
    nu_hat = nu / (1 - b2^t); when rho >= 5 (from t = 6 on with the
    defaults) u = r mu_hat / (sqrt(nu_hat) + eps), r = sqrt((rho - 4)(rho
    - 2) rho_inf / ((rho_inf - 4)(rho_inf - 2) rho)), eps outside the root;
    else u = mu_hat.  Then p += u * (-lr * schedule(t - 1)).  The moments
    are f32."""
    step_size = float(f32(-cfg.lr) * f32(schedule(state.count)))
    state.count += 1
    # the scalars in f32 as XLA computes them (torch.pow rounds b^t as
    # XLA's pow does; numpy's does not at every t); rho_inf's products are
    # Python floats first, as in optax
    t = torch.tensor(state.count, dtype=torch.float32)
    b1t = torch.pow(torch.tensor(b1, dtype=torch.float32), t)
    b2t = torch.pow(torch.tensor(b2, dtype=torch.float32), t)
    rho_inf = 2.0 / (1.0 - b2) - 1.0
    rho = f32(rho_inf) - (f32(2) * t * b2t / (f32(1) - b2t)).numpy()
    c1 = float(f32(1.0) - b1t.numpy())
    c2 = float(f32(1.0) - b2t.numpy())
    rectify = None
    if rho >= f32(RADAM_THRESHOLD):
        rectify = float(np.sqrt(
            (rho - f32(4.0)) * (rho - f32(2.0)) * f32(rho_inf)
            / (f32((rho_inf - 4.0) * (rho_inf - 2.0)) * rho)))
    for p, g, mu, nu in zip(leaves, grads, state.mu, state.nu):
        g = torch.zeros_like(p) if g is None else g.float()
        if cfg.weight_decay:
            g = g + cfg.weight_decay * p
        mu.copy_((1.0 - b1) * g + b1 * mu)
        nu.copy_((1.0 - b2) * (g * g) + b2 * nu)
        mu_hat = mu / c1
        if rectify is None:
            upd = mu_hat
        else:
            upd = rectify * mu_hat / (torch.sqrt(nu / c2) + cfg.eps)
        p.add_(upd * step_size)


def group_update(cfg: AdamOptimizerConfig, schedule: Callable,
                 state: AdamState, leaves, grads) -> None:
    """One update of a param group: RAdam for a ``RAdamOptimizerConfig``,
    else Adam."""
    update = (radam_update if isinstance(cfg, RAdamOptimizerConfig)
              else adam_update)
    update(cfg, schedule, state, leaves, grads)
