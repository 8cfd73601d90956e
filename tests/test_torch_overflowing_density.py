"""The occupancy-grid methods' train step where the density overflows.

trunc_exp's forward is a plain exp, so a density head that trains past
~88.7 gives an inf density in f32.  The occupancy models evaluate every
sample of a ray, the invalid ones too, and mask those to 0 afterwards.
The mask must not multiply: 0 * inf is NaN, the rendering weights scrub
it in the forward (the loss stays finite) but the backward carries it
into every field parameter, and the next step's loss is NaN.  With the
camera optimizer on, the rendering weights' ``deltas * densities`` takes
the same 0 * inf in its backward to the deltas, and the poses'
gradient is NaN.

Small configs as ``tests/test_torch_ngp_step.py`` and
``tests/test_torch_nerfplayer_decomposition.py`` have them, seeded
weights with the density head's bias at 100 (every density inf), and a
grid sparse enough that most rays end with invalid samples.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from soccernerfs_tpu_torch.configs import method_configs as tmc
from soccernerfs_tpu_torch.core import camera_optimizer as tco
from soccernerfs_tpu_torch.core import cameras as tcam
from soccernerfs_tpu_torch.engine.trainer import TrainStep
from soccernerfs_tpu_torch.models import get_model
from soccernerfs_tpu_torch.utils.tree import tree_leaves

CPU = "cpu"
_OCC = dict(grid_resolution=16, num_probes_per_ray=64,
            max_num_samples_per_ray=12, eval_num_rays_per_chunk=64)
SMALL = {
    "instant-ngp": dict(max_res=128, log2_hashmap_size=12, **_OCC),
    "instant-ngp-bounded": dict(
        max_res=128, log2_hashmap_size=12, contraction_type="aabb",
        render_step_size=0.001, near_plane=0.01, background_color="black",
        **_OCC),
    "nerfplayer-ngp": dict(
        num_levels=4, temporal_dim=8, log2_hashmap_size=12, max_res=256,
        near_plane=0.01, temporal_tv_weight=0.05, **_OCC),
    "nerfplayer-ngp-complete": dict(
        num_levels=3, temporal_dim=8, log2_hashmap_size=12, **_OCC),
}
# the MLP whose first output is the density's logit
DENSITY_MLP = {"instant-ngp": "mlp_base", "instant-ngp-bounded": "mlp_base",
               "nerfplayer-ngp": "mlp_base",
               "nerfplayer-ngp-complete": "mlp_base_decode"}
AABB = np.array([[-1.5] * 3, [1.5] * 3], np.float32)
H = W = 8
N_RAYS = 64
N_CAMS = 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch CPU thread while this file runs (the suite runs in
    parallel worker processes)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cameras():
    """Three cameras on +z looking down -z at three times."""
    c2w = np.tile(np.eye(3, 4, dtype=np.float32)[None], (N_CAMS, 1, 1))
    c2w[:, :, 3] = [[0.2, -0.1, 3.0], [-0.3, 0.2, 2.8], [0.0, 0.1, 3.2]]
    return tcam.Cameras.create(
        camera_to_worlds=c2w, fx=7.0, fy=7.5, cx=4.1, cy=3.9, width=W,
        height=H, times=np.array([0.05, 0.5, 0.93], np.float32), device=CPU)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "cam_idx": torch.from_numpy(rng.integers(0, N_CAMS, N_RAYS).astype(np.int32)),
        "coords": torch.from_numpy(rng.uniform(0, H, (N_RAYS, 2)).astype(np.float32)),
        "image": torch.from_numpy(rng.uniform(0, 1, (N_RAYS, 3)).astype(np.float32)),
    }


def _sparse_occs(seed=0, p=0.05):
    """A 16^3 grid whose cells are dense (U(0.5, 1)) with probability
    ``p``, else empty."""
    rng = np.random.default_rng(seed)
    n = 16**3
    return torch.from_numpy(np.where(rng.uniform(size=n) < p,
                                     rng.uniform(0.5, 1.0, n), 0.0)
                            .astype(np.float32))


@pytest.mark.parametrize("pose", [False, True], ids=["registered", "SO3xR3"])
@pytest.mark.parametrize("method", list(SMALL))
def test_an_overflowed_density_at_invalid_samples_keeps_the_step_finite(
        method, pose):
    """Every density inf: the eval forward gives each ray that has a valid
    sample an accumulation of exactly 1 and finite outputs; a train step
    past the grid's warm-up has invalid samples, a finite loss and a finite
    gradient on every leaf (the poses' too, with the camera optimizer on,
    its adjustments seeded off zero); two train iterations from there stay
    finite."""
    cfg = dataclasses.replace(tmc.model_configs[method], **SMALL[method])
    model = get_model(tmc.model_names[method])
    params = model.init(cfg, N_CAMS, torch.Generator().manual_seed(0),
                        device=CPU)
    with torch.no_grad():
        params["fields"][DENSITY_MLP[method]]["b"][-1][0] = 100.0
    cams = _cameras()
    groups, camera_optimizer = (tmc.optimizer_configs[method],
                                tmc.camera_optimizer_configs[method])
    if pose:
        groups = dict(groups,
                      camera_opt=tmc.optimizer_configs["nerfacto"]["camera_opt"])
        camera_optimizer = tco.CameraOptimizerConfig(mode="SO3xR3")
    trainer = TrainStep(cfg, cams, AABB, groups, device=CPU,
                        model=tmc.model_names[method],
                        camera_optimizer=camera_optimizer)
    state = trainer.init_state(params, aux={"occs": _sparse_occs()})
    if pose:
        adjustment = state.params["camera_opt"]["pose_adjustment"]
        with torch.no_grad():
            adjustment.copy_(1e-3 * torch.randn(
                adjustment.shape, generator=torch.Generator().manual_seed(1)))
    state.step = 272
    batch = _batch(5)

    with torch.no_grad():
        rays = tcam.generate_rays(cams, batch["cam_idx"], batch["coords"])
        out = model.get_outputs(cfg, state.params, trainer.aabb, rays,
                                **model.eval_kwargs(cfg, state.aux))
    alive = out["alive_ray_mask"]
    assert bool(alive.any()) and not bool(out["valid"].all())
    for key in ("rgb", "accumulation", "depth", "weights"):
        assert bool(torch.isfinite(out[key]).all()), key
    assert torch.equal(out["accumulation"][alive],
                       torch.ones_like(out["accumulation"][alive]))

    gen = torch.Generator().manual_seed(0)
    loss, _ld, metrics, grads = trainer.loss_and_grads(
        state, batch, train_proposal_networks=True, generator=gen)
    assert float(metrics["num_samples_per_batch"]) < N_RAYS * 12
    assert bool(torch.isfinite(loss))
    leaves = tree_leaves(state.params)
    bad = [i for i, g in enumerate(grads)
           if g is not None and not bool(torch.isfinite(g).all())]
    assert not bad, f"non-finite gradients at leaves {bad} of {len(leaves)}"
    for _ in range(2):
        metrics = trainer.train_iteration(state, batch, gen)
        assert all(bool(torch.isfinite(v)) for v in metrics.values()), metrics
    assert all(bool(torch.isfinite(leaf).all()) for leaf in leaves)
