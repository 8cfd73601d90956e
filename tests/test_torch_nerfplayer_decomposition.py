"""The port's decomposition-field slice (soccernerfs_tpu_torch: the full
NeRFPlayer field, ``nerfplayer`` and ``nerfplayer-ngp-complete``) against
the JAX package on the CPU: ``render_decomposition``, the field's density,
geo features and component probabilities, its colour head and temporal
TV, each model's eval outputs, one whole train step of each method (every
loss term, and every gradient leaf in L2 against ``jax.value_and_grad``),
the occupancy grid after one sampled update, the registry copies and the
parameter conversion.

Small configs from the registry entries: the decomposition field at 3
levels (the static zline grid to resolution 33, level 0 dense at 2^12
rows; the temporal grids 3 levels x (2 + 8 temporal channels) to 1024),
nerfplayer's proposal grids 3 levels x (2 + 6) to 32 and 64 at 2^11 rows,
(12, 8) + 6 samples; nerfplayer-ngp-complete's 16^3 occupancy grid, 64
probes and 12 samples per ray; 64 rays from three cameras at three times.
The tables are scaled from the init's U(+-1e-4) to +-0.3, so that the
encodings shape densities and gradients.  The deformation MLP's random
weights move most points by a few tenths: many deformed points leave the
unit cube, where the stationary grid hashes negative lattice coordinates.
Torch cannot reproduce JAX's PRNG streams: the tests rebuild JAX's draws
(jitters, background, the TV rows, the grid update's) from its key splits
and hand them to the port.  Inputs are made with numpy from a seed; every
tolerance is stated with its reason.
"""
import dataclasses
import functools

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from soccernerfs_tpu.configs.method_configs import method_configs
from soccernerfs_tpu.core import camera_optimizer as jco
from soccernerfs_tpu.core import cameras as jcam
from soccernerfs_tpu.core import rays as jrays
from soccernerfs_tpu.engine import optimizers as jopt
from soccernerfs_tpu.fields import nerfplayer as jf
from soccernerfs_tpu.models import instant_ngp as jin
from soccernerfs_tpu.models import nerfplayer as jnp_model
from soccernerfs_tpu.models import nerfplayer_ngp_complete as jnc
from soccernerfs_tpu.ops import hash_grid as jh
from soccernerfs_tpu.ops import rendering as jr
from soccernerfs_tpu_torch import convert
from soccernerfs_tpu_torch.configs import method_configs as tmc
from soccernerfs_tpu_torch.core import camera_optimizer as tco
from soccernerfs_tpu_torch.core import cameras as tcam
from soccernerfs_tpu_torch.engine.render import render_camera
from soccernerfs_tpu_torch.engine.trainer import TrainStep
from soccernerfs_tpu_torch.fields import nerfplayer as tf
from soccernerfs_tpu_torch.models import get_model
from soccernerfs_tpu_torch.models import nerfplayer as tnp
from soccernerfs_tpu_torch.models import nerfplayer_ngp_complete as tnc
from soccernerfs_tpu_torch.ops import rendering as tr
from soccernerfs_tpu_torch.ops.hash_grid import level_layout, strided_levels
from soccernerfs_tpu_torch.ops.kernels import scatter_kernels as sk
from soccernerfs_tpu_torch.ops.mlp import mlp_apply
from soccernerfs_tpu_torch.utils.tree import tree_leaves


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch CPU thread while this file runs.  The suite runs in
    parallel worker processes; a full-width torch thread pool in each of
    them oversubscribes the cores, and its threads' spin-waiting then slows
    these many small ops by two orders of magnitude."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


CPU = "cpu"
_FIELD = dict(num_levels=3, temporal_dim=8, log2_hashmap_size=12)
SMALL = {
    "nerfplayer": dict(
        _FIELD, num_proposal_samples_per_ray=(12, 8), num_nerf_samples_per_ray=6,
        proposal_net_args_list=(
            {"hidden_dim": 8, "temporal_dim": 6, "log2_hashmap_size": 11,
             "num_levels": 3, "max_res": 32},
            {"hidden_dim": 8, "temporal_dim": 6, "log2_hashmap_size": 11,
             "num_levels": 3, "max_res": 64},
        ),
        eval_num_rays_per_chunk=64),
    "nerfplayer-ngp-complete": dict(
        _FIELD, grid_resolution=16, num_probes_per_ray=64,
        max_num_samples_per_ray=12, eval_num_rays_per_chunk=64),
}
METHODS = list(SMALL)
AABB = np.array([[-1.5] * 3, [1.5] * 3], np.float32)
H = W = 8
N_RAYS = 64
N_CAMS = 3
LOSS_TOL = 1e-4
GRAD_L2_TOL = 1e-2


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rel(got, want) -> float:
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


def _l2(got, want) -> float:
    got, want = _np(got), _np(want)
    return float(np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-30))


def _camera_args():
    """Three cameras on +z looking down -z at three times; every ray
    enters the scene box through its +z face."""
    c2w = np.tile(np.eye(3, 4, dtype=np.float32)[None], (N_CAMS, 1, 1))
    c2w[:, :, 3] = [[0.2, -0.1, 3.0], [-0.3, 0.2, 2.8], [0.0, 0.1, 3.2]]
    return dict(camera_to_worlds=c2w, fx=7.0, fy=7.5, cx=4.1, cy=3.9,
                width=W, height=H, times=np.array([0.05, 0.5, 0.93], np.float32))


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "cam_idx": rng.integers(0, N_CAMS, N_RAYS).astype(np.int32),
        "coords": rng.uniform(0, H, (N_RAYS, 2)).astype(np.float32),
        "image": rng.uniform(0, 1, (N_RAYS, 3)).astype(np.float32),
    }


def _occs(seed=0, p=0.5):
    """A 16^3 grid whose cells are empty (0) or dense (U(0.5, 1)), so that
    both sides binarize it alike."""
    rng = np.random.default_rng(seed)
    n = 16**3
    return np.where(rng.uniform(size=n) < p, rng.uniform(0.5, 1.0, n),
                    0.0).astype(np.float32)


def _jax_outputs(out):
    """A forward's outputs as the JAX package's: arrays, samples, lists."""
    def conv(x):
        if isinstance(x, (list, tuple)):
            return [conv(v) for v in x]
        if isinstance(x, torch.Tensor):
            return jnp.asarray(x.detach().numpy())
        return jrays.RaySamples(**{
            f.name: (getattr(x, f.name) if f.name == "spacing"
                     else None if getattr(x, f.name) is None
                     else jnp.asarray(getattr(x, f.name).detach().numpy()))
            for f in dataclasses.fields(x)})

    return {k: conv(v) for k, v in out.items()}


def _walk(tree, fn, path=()):
    if isinstance(tree, dict):
        return {k: _walk(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_walk(v, fn, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def _lift(path, x):
    x = np.asarray(x)
    return x * 3000.0 if path[-1] == "embeddings" else x


def _jax_train_draws(method, cfg, key, key_loss, n):
    """The JAX step's draws from its keys.  get_outputs splits its key into
    (sampling, background); nerfplayer's proposal sampler splits the
    sampling key into one key per level (a single jitter each), the
    occupancy sampler draws its [N, 1] jitter from it; the background is
    uniform [N, 3].  The temporal TV: nerfplayer's get_loss_dict splits its
    key into one for the field and one per proposal field; the field's
    (nerfplayer-ngp-complete's loss key itself) splits into the newness and
    the decomposition grid's; each draws an index_list row."""
    rng_s, rng_bg = jax.random.split(key)
    background = _t(jax.random.uniform(rng_bg, (n, 3)))
    tcfg_temporal = jh.HashGridConfig(**dataclasses.asdict(
        cfg.field_config().temporal_grid))
    if method == "nerfplayer":
        keys = jax.random.split(rng_s, cfg.num_proposal_iterations + 1)
        jitters = [_t(jax.random.uniform(k, (n, 1))) for k in keys]
        unique = dict(cfg.density_field_configs())
        loss_keys = jax.random.split(key_loss, 1 + len(unique))
        field_key, prop_keys = loss_keys[0], loss_keys[1:]
        prop_grids = [jh.HashGridConfig(**dataclasses.asdict(unique[i].grid))
                      for i in sorted(unique)]
    else:
        jitters = [_t(jax.random.uniform(rng_s, (n, 1)))]
        field_key, prop_keys, prop_grids = key_loss, [], []
    k1, k2 = jax.random.split(field_key)
    rows = [int(jax.random.randint(k, (), 0, jh.temporal_tables(g)[3].shape[0]))
            for k, g in zip([k1, k2, *prop_keys],
                            [tcfg_temporal, tcfg_temporal, *prop_grids])]
    return {"jitters": jitters, "background": background, "tv_rows": rows}


def _jax_aux_draws(rng, step, tcfg):
    """The draws of the JAX update_aux from its key: (time, update) keys;
    update_occupancy_grid splits its key into (jitter, uniform cells,
    occupied-cell uniforms)."""
    rng_t, rng = jax.random.split(rng)
    draws = {"time": _t(jax.random.uniform(rng_t, ()))}
    k_jit, k_uni, k_occ = jax.random.split(rng, 3)
    n = tcfg.occ.n_cells
    if step < tcfg.occ.warmup_steps:
        return {**draws, "jitter": _t(jax.random.uniform(k_jit, (n, 3)))}
    m = n // 4
    return {**draws, "jitter": _t(jax.random.uniform(k_jit, (m, 3))),
            "cells": _t(jax.random.randint(k_uni, (m // 2,), 0, n)).long(),
            "occupied": _t(jax.random.uniform(k_occ, (m - m // 2,)))}


def _modules(method):
    return (jnp_model, tnp) if method == "nerfplayer" else (jnc, tnc)


@pytest.fixture(scope="module", params=METHODS)
def setup(request):
    method = request.param
    jm, tm = _modules(method)
    jcfg = dataclasses.replace(method_configs[method].pipeline.model,
                               **SMALL[method])
    tcfg = dataclasses.replace(tmc.model_configs[method], **SMALL[method])
    np_tree = _walk(jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(0), jcfg, N_CAMS)), _lift)
    jcams = jcam.Cameras.create(**_camera_args())
    aabb = jnp.asarray(AABB)
    occupancy = method != "nerfplayer"

    def make_jax_step(jcfg):
        @functools.partial(jax.jit, static_argnums=(4,))
        def jax_step(params, batch, key, key_loss, flag, step, binary):
            """The loss_fn of the JAX Trainer's shard_loss_and_grads (camera
            optimizer off) with the step's schedules: nerfplayer's anneal
            and proposal flag, nerfplayer-ngp-complete's binarized grid."""

            def loss_fn(p):
                rays = jcam.generate_rays(jcams, batch["cam_idx"], batch["coords"])
                kw = ({"occ_binary": binary} if occupancy else
                      {"anneal": jm._kp.proposal_anneal(jcfg, step),
                       "train_proposal_networks": flag})
                outputs = jm.get_outputs(jcfg, p, aabb, rays, rng=key,
                                         train=True, **kw)
                metrics = jm.get_metrics_dict(jcfg, outputs, batch, step)
                loss_dict = jm.get_loss_dict(jcfg, p, outputs, batch, metrics,
                                             train=True, rng=key_loss)
                return functools.reduce(jnp.add, loss_dict.values()), (
                    loss_dict, metrics)

            return jax.value_and_grad(loss_fn, has_aux=True)(params)

        return jax_step

    return dict(method=method, jm=jm, tm=tm, jcfg=jcfg, tcfg=tcfg,
                np_tree=np_tree, jax_step=make_jax_step(jcfg),
                make_jax_step=make_jax_step, jcams=jcams,
                occupancy=occupancy)


def _trainer(method, tcfg):
    cams = tcam.Cameras.create(**_camera_args(), device=CPU)
    return TrainStep(tcfg, cams, AABB, tmc.optimizer_configs[method],
                     device=CPU, model=tmc.model_names[method],
                     camera_optimizer=tmc.camera_optimizer_configs[method])


def _grad_pairs(state, grads, jgrads):
    """[(leaf path, port gradient or None, JAX gradient)] per leaf."""
    names = []
    _walk(state.params, lambda path, x: names.append(path))
    tgrads = dict(zip(names, grads))
    jflat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert len(jflat) == len(names)
    return [(tuple(p.key if hasattr(p, "key") else p.idx for p in path),
             tgrads[tuple(p.key if hasattr(p, "key") else p.idx for p in path)],
             jg) for path, jg in jflat]


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flag", [True, False])
def test_train_step_matches_jax(setup, flag):
    """One train step (nerfplayer at step 300, anneal 0.845, proposal
    update on and off; nerfplayer-ngp-complete at step 272 over a grid
    that is empty or dense cell by cell, where the flag is inert):
    the loss, each loss term (rgb, interlevel, distortion, the temporal TV
    over the four or two temporal grids, the probability regulariser) and
    the metrics, and the gradient of every parameter before the update
    (the three tables, the deformation, stationary, decomposition, decode
    and colour MLPs, the proposal fields), against jax.value_and_grad of
    the JAX step with the same params, batch and draws.

    Tolerances: the loss terms 1e-4 relative (f32 sums in another order,
    bf16 MLP operands that round the other way on a rounding boundary);
    the gradients per leaf 1e-2 in L2 (C.7: a flipped bf16 rounding moves
    single elements by a 2^-8 step, and in this field it also moves a
    deformed point, whose multilinear weights' gradient jumps across a
    cell face).  nerfplayer's proposal MLPs get no gradient on a
    non-update step (JAX: zeros)."""
    method, jcfg, tcfg = setup["method"], setup["jcfg"], setup["tcfg"]
    step = 272 if setup["occupancy"] else 300
    batch = _batch()
    occs = _occs(1, p=0.3)
    key, key_loss = jax.random.PRNGKey(11), jax.random.PRNGKey(12)
    (jloss, (jld, jmet)), jgrads = setup["jax_step"](
        jax.tree_util.tree_map(jnp.asarray, setup["np_tree"]),
        {k: jnp.asarray(v) for k, v in batch.items()}, key, key_loss, flag,
        step, jin.occupancy_binary(jcfg.occ, jnp.asarray(occs))
        if setup["occupancy"] else None)

    trainer = _trainer(method, tcfg)
    state = trainer.init_state(
        convert.params_from_jax(setup["np_tree"], device=CPU),
        aux=(convert.aux_from_jax({"occs": occs}, device=CPU)
             if setup["occupancy"] else None))
    state.step = step
    draws = _jax_train_draws(method, tcfg, key, key_loss, N_RAYS)
    loss, ld, met, grads = trainer.loss_and_grads(
        state, {k: _t(v) for k, v in batch.items()},
        train_proposal_networks=flag, **draws)

    want_terms = (["rgb_loss", "temporal_tv_loss", "prob_loss"]
                  if setup["occupancy"] else
                  ["rgb_loss", "interlevel_loss", "distortion_loss",
                   "temporal_tv_loss", "prob_loss"])
    # the port's insertion order, in which the total is summed (a jitted
    # dict comes back with sorted keys)
    assert list(ld) == want_terms and set(jld) == set(ld)
    assert set(jmet) == set(met)
    assert _rel(loss, jloss) <= LOSS_TOL
    for k in jld:
        assert _rel(ld[k], jld[k]) <= LOSS_TOL, k
        assert float(np.abs(np.asarray(jld[k]))) > 0.0, k
    for k in jmet:
        assert _rel(met[k], jmet[k]) <= LOSS_TOL, k
    checked = 0
    for name, g, jg in _grad_pairs(state, grads, jgrads):
        if g is None:
            assert not flag and name[0] == "proposal_networks", name
            assert name[2] == "mlp" and np.abs(np.asarray(jg)).max() == 0.0, name
            continue
        assert tuple(g.shape) == jg.shape, name
        assert np.abs(np.asarray(jg)).max() > 0.0, name
        assert _l2(g, jg) <= GRAD_L2_TOL, (name, _l2(g, jg))
        checked += 1
    n_leaves = len(tree_leaves(state.params))
    proposal_mlps = 0 if flag or setup["occupancy"] else 8
    assert checked == n_leaves - proposal_mlps
    assert checked >= 24


def test_train_step_with_the_camera_optimizer_matches_jax(setup):
    """One train step as test_train_step_matches_jax's (update on) with the
    SO3xR3 camera optimizer on, non-zero pose adjustments and the encodes'
    inputs differentiated (``detached_inputs=False``, as both Trainers set
    it): the raw points' stationary, newness and decomposition encodes
    then carry the pose's gradient beside the deformed points' encode.
    Loss terms within 1e-4 relative, every leaf within 1e-2 in L2, the
    pose's included (the tolerances above), against jax.value_and_grad of
    the JAX Trainer's loss_fn with ``input_grads=True``."""
    method, jm = setup["method"], setup["jm"]
    jcfg = dataclasses.replace(setup["jcfg"], detached_inputs=False)
    tcfg = dataclasses.replace(setup["tcfg"], detached_inputs=False)
    rng = np.random.default_rng(19)
    np_tree = dict(setup["np_tree"], camera_opt={"pose_adjustment": (
        rng.standard_normal((N_CAMS, 6)) * 0.02).astype(np.float32)})
    jcam_cfg = jco.CameraOptimizerConfig(mode="SO3xR3")
    jcams, aabb = setup["jcams"], jnp.asarray(AABB)
    step = 272 if setup["occupancy"] else 300
    batch = _batch(4)
    occs = _occs(1, p=0.3)
    binary = (jin.occupancy_binary(jcfg.occ, jnp.asarray(occs))
              if setup["occupancy"] else None)
    key, key_loss = jax.random.PRNGKey(31), jax.random.PRNGKey(32)

    @jax.jit
    def jax_step(params, batch):
        def loss_fn(p):
            cam_opt = jco.apply_camera_optimizer(jcam_cfg, p["camera_opt"],
                                                 batch["cam_idx"])
            rays = jcam.generate_rays(jcams, batch["cam_idx"], batch["coords"],
                                      cam_opt)
            kw = ({"occ_binary": binary} if setup["occupancy"] else
                  {"anneal": jm._kp.proposal_anneal(jcfg, step),
                   "train_proposal_networks": True})
            outputs = jm.get_outputs(jcfg, p, aabb, rays, rng=key, train=True,
                                     **kw)
            metrics = jm.get_metrics_dict(jcfg, outputs, batch, step)
            loss_dict = jm.get_loss_dict(jcfg, p, outputs, batch, metrics,
                                         train=True, rng=key_loss)
            return functools.reduce(jnp.add, loss_dict.values()), loss_dict

        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    (jloss, jld), jgrads = jax_step(
        jax.tree_util.tree_map(jnp.asarray, np_tree),
        {k: jnp.asarray(v) for k, v in batch.items()})
    groups = dict(tmc.optimizer_configs[method],
                  camera_opt=tmc.optimizer_configs["nerfacto"]["camera_opt"])
    trainer = TrainStep(tcfg, tcam.Cameras.create(**_camera_args(), device=CPU),
                        AABB, groups, device=CPU, model=tmc.model_names[method],
                        camera_optimizer=tco.CameraOptimizerConfig(mode="SO3xR3"))
    state = trainer.init_state(
        convert.params_from_jax(np_tree, device=CPU),
        aux=(convert.aux_from_jax({"occs": occs}, device=CPU)
             if setup["occupancy"] else None))
    state.step = step
    draws = _jax_train_draws(method, tcfg, key, key_loss, N_RAYS)
    loss, ld, _met, grads = trainer.loss_and_grads(
        state, {k: _t(v) for k, v in batch.items()},
        train_proposal_networks=True, **draws)
    assert set(jld) == set(ld)
    assert _rel(loss, jloss) <= LOSS_TOL
    for k in jld:
        assert _rel(ld[k], jld[k]) <= LOSS_TOL, k
    pairs = _grad_pairs(state, grads, jgrads)
    for name, g, jg in pairs:
        assert g is not None and tuple(g.shape) == jg.shape, name
        assert _l2(g, jg) <= GRAD_L2_TOL, (name, _l2(g, jg))
    pose = [g for name, g, _jg in pairs if name == ("camera_opt", "pose_adjustment")]
    assert len(pose) == 1 and float(pose[0].abs().max()) > 0


@pytest.mark.parametrize("kind", ["ds_nerf", "urf"])
def test_train_step_with_depth_matches_jax(setup, kind):
    """One train step as above (update on) with ``depth_weight`` 0.05 on a
    batch with target depths in [2, 4] (~10 % of them 0, no target):
    nerfplayer's DS-NeRF (or URF) loss over the three levels' weights,
    nerfplayer-ngp-complete's L1 of the rendered depth (``kind`` inert),
    beside every other term, and every gradient leaf, against
    jax.value_and_grad.  Tolerances as above: loss terms 1e-4 relative,
    leaves 1e-2 in L2."""
    method = setup["method"]
    depth = dict(depth_weight=0.05, depth_loss_type=kind)
    if method != "nerfplayer":
        depth = dict(depth_weight=0.05)
    jcfg = dataclasses.replace(setup["jcfg"], **depth)
    tcfg = dataclasses.replace(setup["tcfg"], **depth)
    step = 272 if setup["occupancy"] else 300
    batch = _batch()
    rng = np.random.default_rng(9)
    batch["depth_image"] = rng.uniform(2, 4, N_RAYS).astype(np.float32)
    batch["depth_image"][rng.uniform(0, 1, N_RAYS) < 0.1] = 0.0
    occs = _occs(1, p=0.3)
    key, key_loss = jax.random.PRNGKey(11), jax.random.PRNGKey(12)
    (jloss, (jld, jmet)), jgrads = setup["make_jax_step"](jcfg)(
        jax.tree_util.tree_map(jnp.asarray, setup["np_tree"]),
        {k: jnp.asarray(v) for k, v in batch.items()}, key, key_loss, True,
        step, jin.occupancy_binary(jcfg.occ, jnp.asarray(occs))
        if setup["occupancy"] else None)
    trainer = _trainer(method, tcfg)
    state = trainer.init_state(
        convert.params_from_jax(setup["np_tree"], device=CPU),
        aux=(convert.aux_from_jax({"occs": occs}, device=CPU)
             if setup["occupancy"] else None))
    state.step = step
    draws = _jax_train_draws(method, tcfg, key, key_loss, N_RAYS)
    loss, ld, met, grads = trainer.loss_and_grads(
        state, {k: _t(v) for k, v in batch.items()},
        train_proposal_networks=True, **draws)
    assert list(ld)[:2] == (["rgb_loss", "depth_loss"] if setup["occupancy"]
                            else ["rgb_loss", "interlevel_loss"])
    assert "depth_loss" in ld and set(jld) == set(ld) and set(jmet) == set(met)
    assert float(ld["depth_loss"]) > 0.0
    assert _rel(loss, jloss) <= LOSS_TOL
    for k in jld:
        assert _rel(ld[k], jld[k]) <= LOSS_TOL, k
    for k in jmet:
        assert _rel(met[k], jmet[k]) <= LOSS_TOL, k
    for name, g, jg in _grad_pairs(state, grads, jgrads):
        assert g is not None and _l2(g, jg) <= GRAD_L2_TOL, (name, _l2(g, jg))


@pytest.mark.parametrize("setup", ["nerfplayer-ngp-complete"], indirect=True)
def test_update_aux_after_the_step_matches_jax(setup):
    """nerfplayer-ngp-complete's sampled grid update after a step at 272:
    JAX's step, optax's update of the params, then the JAX update_aux at
    the pre-increment step; the port's update_aux from the same updated
    params and grid with JAX's draws (the probe time, the cell jitter, the
    uniform and the occupied cells).  The grid within 1e-5 of its max in
    L2 and 1e-3 of it per cell (the probe densities pass through the bf16
    MLPs, the deformation's included, whose roundings may flip between
    XLA's and torch's products); the same cells move."""
    jcfg, tcfg, jm, tm = setup["jcfg"], setup["tcfg"], setup["jm"], setup["tm"]
    step = 272
    occs = _occs(2)
    params = jax.tree_util.tree_map(jnp.asarray, setup["np_tree"])
    key, key_loss = jax.random.PRNGKey(21), jax.random.PRNGKey(22)
    _, grads = setup["jax_step"](
        params, {k: jnp.asarray(v) for k, v in _batch(3).items()}, key,
        key_loss, True, step, jin.occupancy_binary(jcfg.occ, jnp.asarray(occs)))
    ref = method_configs[setup["method"]].optimizers["fields"]
    tx = jopt.build_group_optimizer(ref["optimizer"], ref["scheduler"])
    upd, _ = tx.update(grads["fields"], tx.init(params["fields"]), params["fields"])
    params = {"fields": optax.apply_updates(params["fields"], upd)}
    rng_aux = jax.random.PRNGKey(23)
    want = np.asarray(jm.update_aux(jcfg, params, jnp.asarray(AABB), step,
                                    {"occs": jnp.asarray(occs)}, rng_aux)["occs"])
    tparams = convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), device=CPU)
    got = tm.update_aux(tcfg, tparams, _t(AABB), step, {"occs": _t(occs)},
                        draws=_jax_aux_draws(rng_aux, step, tcfg))["occs"].numpy()
    moved = want != occs
    np.testing.assert_array_equal(got != occs, moved)
    assert moved.mean() > 0.2
    assert np.linalg.norm(got - want) <= 1e-5 * np.linalg.norm(want)
    assert np.abs(got - want).max() <= 1e-3 * np.abs(want).max()


def test_train_iteration_runs_the_scatter_on_every_grid(setup, monkeypatch):
    """A short loop through train_iteration: every step launches the
    table gradient (scatter_add_rows' plain version here) for the
    stationary grid twice (the raw and the deformed points' encodes, width
    2) and once per temporal grid (width 1 over the flattened table);
    nerfplayer's update steps once more per proposal grid.  The loss stays
    finite, and nerfplayer-ngp-complete's grid moves on its update step."""
    method, tcfg, tm = setup["method"], setup["tcfg"], setup["tm"]
    calls = []
    plain = sk.scatter_add_rows_plain

    def counted(g, idxs, ws=None, *, rows):
        calls.append((rows, g.shape[1] // idxs.shape[0]))
        return plain(g, idxs, ws, rows=rows)

    monkeypatch.setattr(sk, "scatter_add_rows_plain", counted)
    trainer = _trainer(method, tcfg)
    state = trainer.init_state(
        convert.params_from_jax(setup["np_tree"], device=CPU),
        aux={"occs": _t(_occs(4))} if setup["occupancy"] else None)
    fcfg = tcfg.field_config()
    static = level_layout(fcfg.static_grid)[0][-1]
    temporal = level_layout(fcfg.temporal_grid)[0][-1] * fcfg.temporal_grid.row_channels
    batch = {k: _t(v) for k, v in _batch(5).items()}
    gen = torch.Generator().manual_seed(0)
    state.step = 10_000 if not setup["occupancy"] else 14
    host = {}
    for i in range(7 if not setup["occupancy"] else 4):
        step = state.step
        before = state.aux.get("occs")
        del calls[:]
        metrics = trainer.train_iteration(state, batch, gen)
        assert np.isfinite(float(metrics["Train Loss"]))
        updated = (not setup["occupancy"]
                   and tm.host_static_kwargs(tcfg, step, host)[
                       "train_proposal_networks"])
        assert calls.count((static, 2)) == 2
        assert calls.count((temporal, 1)) == 2
        assert len(calls) == 4 + (2 if updated else 0)
        if setup["occupancy"]:
            assert (state.aux["occs"] is before) == (step != 16)


def test_deformed_points_leave_the_cube_and_their_mlp_trains(setup):
    """The deformation moves some of the points of the unit cube out of it
    (the negative lattice coordinates the stationary grid then hashes),
    and one train_iteration moves the deformation MLP's weights, whose
    gradient comes through the deformed encode's position gradient."""
    method, tcfg = setup["method"], setup["tcfg"]
    params = convert.params_from_jax(setup["np_tree"], device=CPU)
    rng = np.random.default_rng(6)
    pts = _t(rng.uniform(0, 1, (500, 3)).astype(np.float32))
    deformed = pts + mlp_apply(params["fields"]["deformation_field"], pts)
    outside = ~((deformed >= 0) & (deformed <= 1)).all(-1)
    assert float(outside.float().mean()) > 0.05
    trainer = _trainer(method, tcfg)
    state = trainer.init_state(
        params, aux={"occs": _t(_occs(4))} if setup["occupancy"] else None)
    state.step = 600
    for group in state.opt_state.values():
        group.count = 600             # past a schedule's 512-step warm-up
    watch = state.params["fields"]["deformation_field"]["w"][0]
    before = watch.detach().clone()
    metrics = trainer.train_iteration(state, {k: _t(v) for k, v in
                                              _batch(2).items()},
                                      torch.Generator().manual_seed(1))
    assert np.isfinite(float(metrics["Train Loss"]))
    assert not torch.equal(before, watch.detach())


# ---------------------------------------------------------------------------
# eval
# ---------------------------------------------------------------------------

def test_eval_outputs_and_render_camera_match_jax(setup):
    """get_outputs(train=False) on one camera's 64 pixels (time 0.5; the
    occupancy model over a given binary grid) against the JAX package's
    (no jitter, the white eval background): rgb, accumulation and the
    rendered component probabilities to 1e-4 absolute (f32 sums, bf16 MLP
    operands), median depth to 1e-4 relative on at least 62 of 64 rays (it
    jumps where the cumulative weight sits at 0.5), the valid masks equal.
    render_camera returns the probabilities too, equal to one chunk of all
    its pixels, and chunked in 24."""
    method, jcfg, tcfg = setup["method"], setup["jcfg"], setup["tcfg"]
    jm, tm = setup["jm"], setup["tm"]
    occs = _occs(7)
    coords = np.stack(np.meshgrid(np.arange(H), np.arange(W), indexing="ij"),
                      -1).reshape(-1, 2).astype(np.float32) + 0.5
    idx = np.full(H * W, 1, np.int32)
    jrays = jcam.generate_rays(setup["jcams"], jnp.asarray(idx), jnp.asarray(coords))
    kw = ({"occ_binary": jin.occupancy_binary(jcfg.occ, jnp.asarray(occs))}
          if setup["occupancy"] else {})
    jout = jax.jit(lambda p: jm.get_outputs(
        jcfg, p, jnp.asarray(AABB), jrays, rng=None, train=False, **kw))(
        jax.tree_util.tree_map(jnp.asarray, setup["np_tree"]))
    params = convert.params_from_jax(setup["np_tree"], device=CPU)
    cams = tcam.Cameras.create(**_camera_args(), device=CPU)
    rays = tcam.generate_rays(cams, _t(idx), _t(coords))
    aux = convert.aux_from_jax({"occs": occs}, device=CPU) if setup["occupancy"] else None
    extra = tm.eval_kwargs(tcfg, aux) if aux is not None else {}
    with torch.no_grad():
        tout = tm.get_outputs(tcfg, params, _t(AABB), rays, **extra)
    if setup["occupancy"]:
        np.testing.assert_array_equal(tout["valid"].numpy(),
                                      np.asarray(jout["valid"]))
    acc = np.asarray(jout["accumulation"])
    assert 0.05 < float(acc.mean()) < 0.999
    probs = np.asarray(jout["probs"])
    assert probs.shape == (H * W, 3) and float(probs.min()) >= 0.0
    for k in ("rgb", "accumulation", "probs"):
        assert float(np.abs(_np(tout[k]) - np.asarray(jout[k])).max()) <= 1e-4, k
    depth_keys = ["depth"] + ([] if setup["occupancy"]
                              else ["prop_depth_0", "prop_depth_1"])
    for k in depth_keys:
        off = np.abs(_np(tout[k]) - np.asarray(jout[k])) / np.asarray(jout[k])
        assert (off <= 1e-4).sum() >= 62, k
    for chunk in (64, 24):
        image = render_camera(tcfg, params, cams, 1, chunk=chunk, device=CPU,
                              aabb=AABB, model=tmc.model_names[method], aux=aux)
        assert set(image) == {"rgb", "depth", "accumulation", "probs"}
        assert image["probs"].shape == (H, W, 3)
        for k in image:
            torch.testing.assert_close(image[k].reshape(H * W, -1),
                                       tout[k].reshape(H * W, -1), rtol=1e-5,
                                       atol=1e-6)


# ---------------------------------------------------------------------------
# the field and the compositor
# ---------------------------------------------------------------------------

def test_render_decomposition_matches_jax():
    """The probability compositor on random weights and softmax rows: 1e-6
    absolute (one f32 sum of S products, in the same order)."""
    rng = np.random.default_rng(20)
    logits = rng.standard_normal((50, 7, 3)).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    weights = rng.uniform(0, 0.3, (50, 7)).astype(np.float32)
    want = np.asarray(jr.render_decomposition(jnp.asarray(probs), jnp.asarray(weights)))
    got = tr.render_decomposition(_t(probs), _t(weights))
    assert got.shape == (50, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("view_dependent", [False, True])
def test_field_matches_jax(view_dependent):
    """nerfplayer_density (density, geo features, the three components'
    probabilities) at points inside the scene box at times in [0, 1] (0
    and 1 included), the scene box's normalisation and the contraction,
    and the colour head (view-independent as registered, and with SH
    directions), against the JAX package's on the same inputs.

    Density, geo features and probabilities: 1e-5 of the max in L2, and
    per point 1e-4 of the max (1e-4 absolute for the probabilities) on at
    least 498 of 500 points.  Four bf16 MLPs stand between the encodings
    and the geo features here; an operand of one of them that sits on a
    bf16 rounding boundary rounds the other way under XLA's and torch's
    f32 products, a 2^-8 step of one hidden unit, which moves its point
    alone (seen: one point at 1.7e-4 of the max; the deformation's own
    outputs differ by at most 7.5e-8 there).  rgb: 1e-4 absolute."""
    for contraction in (True, False):
        jfc = jf.NerfplayerFieldConfig(
            disable_viewing_dependent=not view_dependent,
            disable_scene_contraction=contraction, **_FIELD)
        tfc = tf.NerfplayerFieldConfig(**dataclasses.asdict(jfc))
        jp = _walk(jax.tree_util.tree_map(np.asarray, jf.init_nerfplayer_field(
            jax.random.PRNGKey(3), jfc)), _lift)
        tp = convert.params_from_jax(jp, device=CPU)
        jp = jax.tree_util.tree_map(jnp.asarray, jp)
        rng = np.random.default_rng(42)
        extent = 1.45 if contraction else 2.5
        pos = rng.uniform(-extent, extent, (500, 3)).astype(np.float32)
        times = rng.uniform(0, 1, 500).astype(np.float32)
        times[:2] = [0.0, 1.0]
        jd, jgeo, jprobs = jf.nerfplayer_density(
            jfc, jp, jnp.asarray(AABB), jnp.asarray(pos), jnp.asarray(times))
        td, tgeo, tprobs = tf.nerfplayer_density(tfc, tp, _t(AABB), _t(pos),
                                                 _t(times))
        assert tgeo.shape == (500, 15) and tprobs.shape == (500, 3)
        for got, want, scale in ((td, jd, None), (tgeo, jgeo, None),
                                 (tprobs, jprobs, 1.0)):
            assert _l2(got, want) <= 1e-5
            want = np.asarray(want).reshape(500, -1)
            off = (np.abs(_np(got).reshape(500, -1) - want).max(-1)
                   / (scale or np.abs(want).max()))
            assert (off <= 1e-4).sum() >= 498, off.max()
        dirs = rng.standard_normal((500, 3)).astype(np.float32)
        dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
        want = jf.nerfplayer_rgb(jfc, jp, jgeo, jnp.asarray(dirs))
        got = tf.nerfplayer_rgb(tfc, tp, tgeo.detach(), _t(dirs))
        assert got.shape == (500, 3)
        assert float(np.abs(_np(got) - np.asarray(want)).max()) <= 1e-4


def test_temporal_tv_matches_jax():
    """nerfplayer_temporal_tv over the newness and the decomposition grid
    with the two index_list rows JAX draws from its key's split: 1e-6
    relative (the same f32 mean of |differences|)."""
    jfc = jf.NerfplayerFieldConfig(**_FIELD)
    tfc = tf.NerfplayerFieldConfig(**_FIELD)
    jp = _walk(jax.tree_util.tree_map(np.asarray, jf.init_nerfplayer_field(
        jax.random.PRNGKey(4), jfc)), _lift)
    tp = convert.params_from_jax(jp, device=CPU)
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        want = float(jf.nerfplayer_temporal_tv(
            jfc, jax.tree_util.tree_map(jnp.asarray, jp), key))
        grid = jh.HashGridConfig(**dataclasses.asdict(jfc.temporal_grid))
        n_rows = jh.temporal_tables(grid)[3].shape[0]
        rows = [int(jax.random.randint(k, (), 0, n_rows))
                for k in jax.random.split(key)]
        got = float(tf.nerfplayer_temporal_tv(tfc, tp, rows))
        assert abs(got - want) <= 1e-6 * abs(want)


# ---------------------------------------------------------------------------
# draws, refusals, configs, conversion
# ---------------------------------------------------------------------------

def test_draws_and_refusals(setup):
    """train_draws gives the jitters, the [N, 3] random background and one
    index_list row per temporal grid (nerfplayer: the newness, the
    decomposition and two proposal grids; nerfplayer-ngp-complete: two);
    a loss without them, rays without times, a train forward without its
    draws and a field with position gradients are refused; a batch with
    target depths gets JAX's depth loss."""
    method, tcfg, tm = setup["method"], setup["tcfg"], setup["tm"]
    draws = tm.train_draws(tcfg, 5, torch.Generator().manual_seed(0), CPU)
    n_levels = 1 if setup["occupancy"] else 3
    assert [tuple(j.shape) for j in draws["jitters"]] == [(5, 1)] * n_levels
    assert draws["background"].shape == (5, 3)
    assert len(draws["tv_rows"]) == (2 if setup["occupancy"] else 4)
    assert all(0 <= int(r) < 7 for r in draws["tv_rows"][:2])
    params = convert.params_from_jax(setup["np_tree"], device=CPU)
    cams = tcam.Cameras.create(**_camera_args(), device=CPU)
    rays = tcam.generate_rays(cams, torch.zeros(4, dtype=torch.int32),
                              torch.full((4, 2), 4.0))
    with pytest.raises(ValueError, match="jitters"):
        tm.get_outputs(tcfg, params, _t(AABB), rays, train=True)
    with pytest.raises(ValueError, match="ray times"):
        tm.get_outputs(tcfg, params, _t(AABB), rays.replace(times=None))
    draws = tm.train_draws(tcfg, 4, torch.Generator().manual_seed(0), CPU)
    with torch.no_grad():
        out = tm.get_outputs(tcfg, params, _t(AABB), rays, train=True,
                             jitters=draws["jitters"],
                             background=draws["background"])
    image = {"image": torch.zeros(4, 3)}
    metrics = tm.get_metrics_dict(tcfg, out, image)
    with pytest.raises(ValueError, match="index_list rows"):
        tm.get_loss_dict(tcfg, params, out, image, metrics)
    # a batch with target depths gets JAX's depth loss on the same outputs
    # (the temporal TV off: it reads the params, not the outputs)
    deep = dataclasses.replace(tcfg, depth_weight=0.05, temporal_tv_weight=0.0)
    jdeep = dataclasses.replace(setup["jcfg"], depth_weight=0.05,
                                temporal_tv_weight=0.0)
    batch = {**image, "depth_image": torch.tensor([1.0, 0.0, 2.5, 3.0])}
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    jout = _jax_outputs(out)
    jmetrics = setup["jm"].get_metrics_dict(jdeep, jout, jbatch, 300)
    want = setup["jm"].get_loss_dict(jdeep, None, jout, jbatch, jmetrics,
                                     train=True)
    got = tm.get_loss_dict(deep, params, out, batch,
                           tm.get_metrics_dict(deep, out, batch, 300))
    assert set(got) == set(want) and float(got["depth_loss"]) > 0.0
    for k in want:
        assert _rel(got[k], want[k]) <= 1e-5, k
    # detached_inputs=False (the camera optimizer's) reaches the field:
    # test_train_step_with_the_camera_optimizer_matches_jax trains it
    assert not dataclasses.replace(
        tcfg, detached_inputs=False).field_config().detached_inputs
    assert get_model(tmc.model_names[method]) is tm


def test_train_configs_copy_the_registry(setup):
    """The port's model config, optimizers (Adam: nerfplayer eps 1e-6 with
    the cosine schedule on both groups, nerfplayer-ngp-complete eps 1e-12
    and none; f32 moments), camera optimizer (off) and rays per batch
    equal the JAX registry's; at registry width the stationary grid has
    3,320,608 (1,747,744) rows of 2, the newness and decomposition grids
    3,088,592 (1,646,800) rows of 66 each."""
    method = setup["method"]
    ref = method_configs[method]
    cfg = tmc.model_configs[method]
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref.pipeline.model)
    assert tmc.model_names[method] == ref.pipeline.model_name
    got = tmc.optimizer_configs[method]
    assert list(got) == list(ref.optimizers)
    for group, gcfg in ref.optimizers.items():
        mine = dataclasses.asdict(got[group]["optimizer"])
        theirs = dataclasses.asdict(gcfg["optimizer"])
        assert mine == {k: theirs[k] for k in mine}
        assert mine["moment_dtype"] is None
        if gcfg["scheduler"] is None:
            assert got[group]["scheduler"] is None
        else:
            assert dataclasses.asdict(got[group]["scheduler"]) == dataclasses.asdict(
                gcfg["scheduler"])
    assert (tmc.camera_optimizer_configs[method].mode
            == ref.pipeline.datamanager.camera_optimizer.mode == "off")
    assert (tmc.train_num_rays_per_batch[method]
            == ref.pipeline.datamanager.train_num_rays_per_batch)
    fcfg = cfg.field_config()
    jfcfg = ref.pipeline.model.field_config()
    assert dataclasses.asdict(fcfg) == dataclasses.asdict(jfcfg)
    for grid, jgrid in ((fcfg.static_grid, jfcfg.static_grid),
                        (fcfg.temporal_grid, jfcfg.temporal_grid)):
        assert dataclasses.asdict(grid) == dataclasses.asdict(jgrid)
        assert level_layout(grid) == jh.level_layout(jgrid)
    sizes = {"nerfplayer": (3_320_608, 3_088_592),
             "nerfplayer-ngp-complete": (1_747_744, 1_646_800)}[method]
    assert (level_layout(fcfg.static_grid)[0][-1],
            level_layout(fcfg.temporal_grid)[0][-1]) == sizes
    assert (fcfg.static_grid.row_channels, fcfg.temporal_grid.row_channels) == (2, 66)
    assert not any(strided_levels(fcfg.static_grid)[4:])


def test_params_round_trip_and_seeded_tree(setup):
    """params_from_jax keeps the JAX tree's structure and values (and
    aux_from_jax the grid); seeded_params builds the same structure and
    shapes without JAX (its tables U(+-grid_std)), and so does the port's
    own init."""
    np_tree, tcfg = setup["np_tree"], setup["tcfg"]
    params = convert.params_from_jax(np_tree, device=CPU)
    shapes = {}
    _walk(np_tree, lambda path, x: shapes.__setitem__(path, np.asarray(x).shape))

    def same(path, x):
        want = np_tree
        for p in path:
            want = want[p]
        np.testing.assert_array_equal(x.numpy(), np.asarray(want))
        assert x.dtype == torch.float32

    _walk(params, same)
    assert set(params["fields"]) == {
        "deformation_field", "stationary_field", "stationary_field_mlp",
        "newness_field", "decomposition_field", "decomposition_mlp",
        "mlp_base_decode", "mlp_head"}
    assert set(params) == ({"fields"} if setup["occupancy"]
                           else {"fields", "proposal_networks"})
    for tree in (convert.seeded_params(tcfg, 3, N_CAMS),
                 setup["tm"].init(tcfg, N_CAMS, torch.Generator().manual_seed(0))):
        got = {}
        _walk(tree, lambda path, x: got.__setitem__(path, tuple(x.shape)))
        assert got == shapes
    table = convert.seeded_params(tcfg, 3, N_CAMS, grid_std=0.5)[
        "fields"]["newness_field"]["embeddings"]
    assert table.shape[1] == 10 and 0.4 < float(np.abs(table).max()) <= 0.5
    if setup["occupancy"]:
        occs = np.asarray(jnc.init_aux(setup["jcfg"])["occs"])
        aux = convert.aux_from_jax({"occs": occs}, device=CPU)
        assert torch.equal(aux["occs"], setup["tm"].init_aux(tcfg)["occs"])
