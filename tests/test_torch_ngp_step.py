"""The port's occupancy-grid methods (instant-ngp, instant-ngp-bounded,
nerfplayer-ngp; soccernerfs_tpu_torch/models/instant_ngp.py and
nerfplayer_ngp.py) against the JAX package on the CPU: the fields'
densities and colours, one eval chunk over a given binary grid and
``render_camera`` with a given state, one whole train step (loss terms and
every gradient before the update) with the same params, batch, grid and
draws, the grid update after the step from the step's updated params, the
trainer's wiring of the state, the registry copies and the conversion.

Small configs: instant-NGP's 16 levels of 2 features (the model config
does not reach the level count) to 128 at 2^12 rows, MLPs of 64; the
NeRFPlayer-NGP temporal grid 4 levels x (2 + 8 temporal channels) to 256
at 2^12 rows; a 16^3 occupancy grid, 64 probes and 12 samples per ray, 96
rays from three cameras at three times.  The tables are scaled from the
init's U(+-1e-4) to +-0.3, so that the encodings shape densities and
gradients.  The grid the step samples is empty or dense cell by cell, so
that both sides binarize it alike.  Torch cannot reproduce JAX's PRNG
streams: the tests make JAX's own draws (jitter, background, TV row, the
update's draws) and hand them to the port.  Inputs are made with numpy
from a seed; every tolerance is stated with its reason.
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
from soccernerfs_tpu.core import cameras as jcam
from soccernerfs_tpu.core import rays as jrays
from soccernerfs_tpu.engine import optimizers as jopt
from soccernerfs_tpu.fields import instant_ngp as jif
from soccernerfs_tpu.fields import nerfplayer_ngp as jpf
from soccernerfs_tpu.models import instant_ngp as jin
from soccernerfs_tpu.models import nerfplayer_ngp as jpn
from soccernerfs_tpu.ops import hash_grid as jh
from soccernerfs_tpu_torch import convert
from soccernerfs_tpu_torch.configs import method_configs as tmc
from soccernerfs_tpu_torch.core import cameras as tcam
from soccernerfs_tpu_torch.engine.render import render_camera
from soccernerfs_tpu_torch.engine.trainer import TrainStep
from soccernerfs_tpu_torch.fields import instant_ngp as tif
from soccernerfs_tpu_torch.fields import nerfplayer_ngp as tpf
from soccernerfs_tpu_torch.models import get_model
from soccernerfs_tpu_torch.models import instant_ngp as tin
from soccernerfs_tpu_torch.models import nerfplayer_ngp as tpn
from soccernerfs_tpu_torch.ops.kernels import scatter_kernels as sk
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
}
METHODS = list(SMALL)
AABB = np.array([[-1.5] * 3, [1.5] * 3], np.float32)
H = W = 8
N_RAYS = 96
N_CAMS = 3


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rel(got, want) -> float:
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


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
    """A 16^3 grid whose cells are empty (0) or dense (U(0.5, 1))."""
    rng = np.random.default_rng(seed)
    n = 16**3
    return np.where(rng.uniform(size=n) < p, rng.uniform(0.5, 1.0, n),
                    0.0).astype(np.float32)


def _walk(tree, fn, path=()):
    if isinstance(tree, dict):
        return {k: _walk(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_walk(v, fn, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def _modules(method):
    """(JAX model, port model) of a method."""
    return (jpn, tpn) if method == "nerfplayer-ngp" else (jin, tin)


def _jax_train_draws(key, key_loss, n, tcfg):
    """The JAX step's draws: get_outputs splits its key into (sampling,
    background), the jitter is uniform(sampling, [N, 1]), the background
    uniform [N, 3]; the temporal TV draws its row from the loss key."""
    rng_s, rng_bg = jax.random.split(key)
    draws = {"jitters": [_t(jax.random.uniform(rng_s, (n, 1)))],
             "background": _t(jax.random.uniform(rng_bg, (n, 3)))}
    if isinstance(tcfg, tpn.Config):
        rows = jh.temporal_tables(tcfg.field_config().grid)[3].shape[0]
        draws["tv_rows"] = [int(jax.random.randint(key_loss, (), 0, rows))]
    return draws


def _jax_aux_draws(rng, step, tcfg):
    """The draws of the JAX update_aux from its key: NeRFPlayer-NGP splits
    it into (time, update) keys first; update_occupancy_grid splits its
    key into (jitter, uniform cells, occupied-cell uniforms)."""
    draws = {}
    if isinstance(tcfg, tpn.Config):
        rng_t, rng = jax.random.split(rng)
        draws["time"] = _t(jax.random.uniform(rng_t, ()))
    k_jit, k_uni, k_occ = jax.random.split(rng, 3)
    n = tcfg.occ.n_cells
    if step < tcfg.occ.warmup_steps:
        return {**draws, "jitter": _t(jax.random.uniform(k_jit, (n, 3)))}
    m = n // 4
    return {**draws, "jitter": _t(jax.random.uniform(k_jit, (m, 3))),
            "cells": _t(jax.random.randint(k_uni, (m // 2,), 0, n)).long(),
            "occupied": _t(jax.random.uniform(k_occ, (m - m // 2,)))}


@pytest.fixture(scope="module", params=METHODS)
def setup(request):
    method = request.param
    jm, tm = _modules(method)
    jcfg = dataclasses.replace(method_configs[method].pipeline.model,
                               **SMALL[method])
    tcfg = dataclasses.replace(tmc.model_configs[method], **SMALL[method])

    def lift(path, x):
        x = np.asarray(x)
        return x * 3000.0 if path[-1] == "embeddings" else x

    np_tree = _walk(jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(0), jcfg, N_CAMS)), lift)
    jcams = jcam.Cameras.create(**_camera_args())
    aabb = jnp.asarray(AABB)

    def make_jax_step(jcfg):
        @jax.jit
        def jax_step(params, batch, key, key_loss, binary, step):
            """The loss_fn of the JAX Trainer's shard_loss_and_grads with the
            step's schedules (the binarized grid)."""

            def loss_fn(p):
                rays = jcam.generate_rays(jcams, batch["cam_idx"], batch["coords"])
                outputs = jm.get_outputs(jcfg, p, aabb, rays, rng=key,
                                         train=True, occ_binary=binary)
                metrics = jm.get_metrics_dict(jcfg, outputs, batch, step)
                loss_dict = jm.get_loss_dict(jcfg, p, outputs, batch, metrics,
                                             train=True, rng=key_loss)
                return functools.reduce(jnp.add, loss_dict.values()), (
                    loss_dict, metrics, outputs["valid"])

            return jax.value_and_grad(loss_fn, has_aux=True)(params)

        return jax_step

    return dict(method=method, jm=jm, tm=tm, jcfg=jcfg, tcfg=tcfg,
                np_tree=np_tree, jax_step=make_jax_step(jcfg),
                make_jax_step=make_jax_step, jcams=jcams)


def _trainer(method, tcfg):
    cams = tcam.Cameras.create(**_camera_args(), device=CPU)
    return TrainStep(tcfg, cams, AABB, tmc.optimizer_configs[method],
                     device=CPU, model=tmc.model_names[method],
                     camera_optimizer=tmc.camera_optimizer_configs[method])


def _jax_binary(jcfg, occs):
    return jin.occupancy_binary(jcfg.occ, jnp.asarray(occs))


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

def test_train_step_matches_jax(setup):
    """One train step at step 272 over a grid that is empty or dense cell
    by cell: the loss, each loss term (the alive-ray-masked rgb loss; for
    nerfplayer-ngp the temporal TV), PSNR and the samples per batch, the
    valid masks, and the gradient of every parameter before the update,
    against jax.value_and_grad of the JAX step with the same params, batch,
    grid and draws.

    The rays come from each side's ``generate_rays``; their probes select
    the same samples (valid masks equal, so the sample count is exact).
    Tolerances, as the other step tests': the loss terms 1e-4 relative (f32
    sums in another order, bf16 MLP operands that round the other way on a
    rounding boundary); the gradients, per tensor, 2e-2 of its max |grad|
    (a flipped bf16 rounding of an MLP operand is a 2^-8 step)."""
    jcfg, tcfg, method = setup["jcfg"], setup["tcfg"], setup["method"]
    step = 272
    batch = _batch()
    occs = _occs(1, p=0.1)      # some rays meet no occupied cell
    key, key_loss = jax.random.PRNGKey(11), jax.random.PRNGKey(12)
    (jloss, (jld, jmet, jvalid)), jgrads = setup["jax_step"](
        jax.tree_util.tree_map(jnp.asarray, setup["np_tree"]),
        {k: jnp.asarray(v) for k, v in batch.items()}, key, key_loss,
        _jax_binary(jcfg, occs), step)

    trainer = _trainer(method, tcfg)
    state = trainer.init_state(
        convert.params_from_jax(setup["np_tree"], device=CPU),
        aux=convert.aux_from_jax({"occs": occs}, device=CPU))
    state.step = step
    draws = _jax_train_draws(key, key_loss, N_RAYS, tcfg)
    tbatch = {k: _t(v) for k, v in batch.items()}
    loss, ld, met, grads = trainer.loss_and_grads(
        state, tbatch, train_proposal_networks=False, **draws)

    rays = tcam.generate_rays(trainer.cameras, tbatch["cam_idx"], tbatch["coords"])
    with torch.no_grad():
        out = setup["tm"].get_outputs(
            tcfg, state.params, trainer.aabb, rays, train=True,
            jitters=draws["jitters"], background=draws["background"],
            **setup["tm"].schedules(tcfg, step, state.aux))
    np.testing.assert_array_equal(out["valid"].numpy(), np.asarray(jvalid))
    alive = out["alive_ray_mask"].float().mean()
    assert 0.5 < alive < 0.98
    assert 0 < out["num_samples_per_ray"].float().mean() < 12

    want_terms = ["rgb_loss"] + (["temporal_tv_loss"] if method == "nerfplayer-ngp"
                                 else [])
    assert list(ld) == list(jld) == want_terms
    assert set(jmet) == set(met) == {"psnr", "num_samples_per_batch"}
    assert _rel(loss, jloss) <= 1e-4
    for k in jld:
        assert _rel(ld[k], jld[k]) <= 1e-4, k
    assert _rel(met["psnr"], jmet["psnr"]) <= 1e-4
    assert int(met["num_samples_per_batch"]) == int(jmet["num_samples_per_batch"])
    names = []
    _walk(state.params, lambda path, x: names.append(path))
    tgrads = dict(zip(names, grads))
    jflat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert len(jflat) == len(names)
    for path, jg in jflat:
        name = tuple(p.key if hasattr(p, "key") else p.idx for p in path)
        g = tgrads[name]
        assert g is not None and tuple(g.shape) == jg.shape, name
        assert np.abs(np.asarray(jg)).max() > 0.0, name
        assert _rel(g, jg) <= 2e-2, (name, _rel(g, jg))


@pytest.mark.parametrize("setup", ["nerfplayer-ngp"], indirect=True)
def test_train_step_with_depth_matches_jax(setup):
    """nerfplayer-ngp's step as above on a batch with target depths in
    [2, 4] (~10 % of them 0, no target), ``depth_weight`` 0.05 as
    registered: the depth loss (the rendered depth's L1 over the rays with
    a target plus 1e-2 of the mean squared density of the valid samples
    more than 3/128 in front of it) beside the other terms, and every
    gradient leaf, against jax.value_and_grad.  Loss terms within 1e-4
    relative; leaves within 1e-2 in L2 (a flipped bf16 rounding of an MLP
    operand moves single elements)."""
    jcfg, tcfg, method = setup["jcfg"], setup["tcfg"], setup["method"]
    step = 272
    batch = _batch()
    rng = np.random.default_rng(9)
    batch["depth_image"] = rng.uniform(2, 4, N_RAYS).astype(np.float32)
    batch["depth_image"][rng.uniform(0, 1, N_RAYS) < 0.1] = 0.0
    occs = _occs(1, p=0.1)
    key, key_loss = jax.random.PRNGKey(11), jax.random.PRNGKey(12)
    (jloss, (jld, jmet, _jvalid)), jgrads = setup["make_jax_step"](jcfg)(
        jax.tree_util.tree_map(jnp.asarray, setup["np_tree"]),
        {k: jnp.asarray(v) for k, v in batch.items()}, key, key_loss,
        _jax_binary(jcfg, occs), step)
    trainer = _trainer(method, tcfg)
    state = trainer.init_state(
        convert.params_from_jax(setup["np_tree"], device=CPU),
        aux=convert.aux_from_jax({"occs": occs}, device=CPU))
    state.step = step
    loss, ld, met, grads = trainer.loss_and_grads(
        state, {k: _t(v) for k, v in batch.items()},
        train_proposal_networks=False,
        **_jax_train_draws(key, key_loss, N_RAYS, tcfg))
    assert list(ld) == ["rgb_loss", "depth_loss", "temporal_tv_loss"]
    assert set(jld) == set(ld) and float(ld["depth_loss"]) > 0.0
    assert _rel(loss, jloss) <= 1e-4
    for k in jld:
        assert _rel(ld[k], jld[k]) <= 1e-4, k
    names = []
    _walk(state.params, lambda path, x: names.append(path))
    tgrads = dict(zip(names, grads))
    for path, jg in jax.tree_util.tree_flatten_with_path(jgrads)[0]:
        name = tuple(p.key if hasattr(p, "key") else p.idx for p in path)
        g, jg = tgrads[name].numpy(), np.asarray(jg)
        assert np.linalg.norm(g - jg) <= 1e-2 * np.linalg.norm(jg), name


@pytest.mark.parametrize("step", [16, 272])
def test_update_aux_after_the_step_matches_jax(setup, step):
    """The grid update after the step: JAX's step, then optax's update of
    the params, then the JAX update_aux at the pre-increment step (16: the
    all-cells update of warmup; 272: the sampled update); the port's
    update_aux from the same updated params and grid with JAX's draws
    (for nerfplayer-ngp the probe time too).  The grid within 1e-5 of its
    max in L2 and 1e-3 of it per cell (the probe densities pass through
    the bf16 MLPs, whose roundings may flip between XLA's and torch's
    products); the same cells move."""
    jcfg, tcfg, method = setup["jcfg"], setup["tcfg"], setup["method"]
    occs = _occs(2)
    params = jax.tree_util.tree_map(jnp.asarray, setup["np_tree"])
    key, key_loss = jax.random.PRNGKey(21), jax.random.PRNGKey(22)
    _, grads = setup["jax_step"](
        params, {k: jnp.asarray(v) for k, v in _batch(3).items()}, key,
        key_loss, _jax_binary(jcfg, occs), step)
    ref = method_configs[method].optimizers["fields"]
    tx = jopt.build_group_optimizer(ref["optimizer"], ref["scheduler"])
    upd, _ = tx.update(grads["fields"], tx.init(params["fields"]), params["fields"])
    params = {"fields": optax.apply_updates(params["fields"], upd)}
    rng_aux = jax.random.PRNGKey(23)
    want = np.asarray(setup["jm"].update_aux(
        jcfg, params, jnp.asarray(AABB), step, {"occs": jnp.asarray(occs)},
        rng_aux)["occs"])
    tparams = convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), device=CPU)
    got = setup["tm"].update_aux(
        tcfg, tparams, _t(AABB), step, {"occs": _t(occs)},
        draws=_jax_aux_draws(rng_aux, step, tcfg))["occs"].numpy()
    moved = want != occs
    np.testing.assert_array_equal(got != occs, moved)
    assert moved.mean() > (0.99 if step < 256 else 0.2)
    scale = np.abs(want).max()
    assert np.linalg.norm(got - want) <= 1e-5 * np.linalg.norm(want)
    assert np.abs(got - want).max() <= 1e-3 * scale


def test_train_iteration_updates_the_grid_after_the_step(setup, monkeypatch):
    """train_iteration from step 14 to 18: scatter_add_rows (its plain
    version here) runs on every step; the grid moves on step 16 only, to
    exactly update_aux of the step's updated params at step 16 with the
    draws the generator gives after the step's train draws; the forward
    of step 17 samples the new grid."""
    method, tcfg, tm = setup["method"], setup["tcfg"], setup["tm"]
    calls = []
    plain = sk.scatter_add_rows_plain

    def counted(g, idxs, ws=None, *, rows):
        calls.append(rows)
        return plain(g, idxs, ws, rows=rows)

    monkeypatch.setattr(sk, "scatter_add_rows_plain", counted)
    seen = []
    schedules = tm.schedules
    monkeypatch.setattr(tm, "schedules", lambda cfg, step, aux: (
        seen.append((step, aux["occs"])), schedules(cfg, step, aux))[1])
    trainer = _trainer(method, tcfg)
    state = trainer.init_state(
        convert.params_from_jax(setup["np_tree"], device=CPU),
        aux={"occs": _t(_occs(4))})
    state.step = 14
    batch = {k: _t(v) for k, v in _batch(5).items()}
    gen = torch.Generator().manual_seed(0)
    for step in range(14, 19):
        before = state.aux["occs"]
        replay = torch.Generator().manual_seed(0)
        replay.set_state(gen.get_state())
        del calls[:]
        metrics = trainer.train_iteration(state, batch, gen)
        assert len(calls) == 1 and np.isfinite(float(metrics["Train Loss"]))
        assert state.step == step + 1
        if step == 16:
            tm.train_draws(tcfg, N_RAYS, replay, CPU)
            want = tm.update_aux(tcfg, state.params, trainer.aabb, step,
                                 {"occs": before},
                                 draws=tm.aux_draws(tcfg, step, replay, CPU))
            assert not torch.equal(state.aux["occs"], before)
            torch.testing.assert_close(state.aux["occs"], want["occs"],
                                       rtol=0, atol=0)
        else:
            assert state.aux["occs"] is before
    assert [s for s, _ in seen] == list(range(14, 19))
    assert seen[3][1] is not seen[2][1]


def test_fresh_state_starts_from_an_empty_grid(setup):
    """init_state without a state takes the model's init_aux: an empty
    grid, under which no cell is occupied, so a step before the first
    update trains no ray (its loss is 0); step 0 then fills the grid with
    the all-cells update."""
    method, tcfg = setup["method"], setup["tcfg"]
    trainer = _trainer(method, tcfg)
    state = trainer.init_state(convert.params_from_jax(setup["np_tree"],
                                                       device=CPU))
    assert state.aux["occs"].shape == (16**3,) and not state.aux["occs"].any()
    metrics = trainer.train_iteration(state, {k: _t(v) for k, v in
                                              _batch(6).items()},
                                      torch.Generator().manual_seed(1))
    assert float(metrics["rgb_loss"]) == 0.0
    assert int(metrics["num_samples_per_batch"]) == 0
    assert bool((state.aux["occs"] > 0).all())


# ---------------------------------------------------------------------------
# eval
# ---------------------------------------------------------------------------

def test_eval_chunk_and_render_camera_match_jax(setup):
    """get_outputs(train=False) on one camera's 64 pixels (time 0.5) over
    a given binary grid, against the JAX package's (no jitter; a random
    background handed to both sides as JAX draws it outside training,
    from PRNGKey(0)): the valid masks equal, rgb and accumulation to 1e-4
    absolute (f32 sums, bf16 MLP operands), median depth to 1e-4 relative
    on at least 62 of 64 rays (it jumps where the cumulative weight sits
    at 0.5).  render_camera with the state {"occs": ...} equals one chunk
    of all its pixels through the model's eval_kwargs of that state
    (chunked in 24 too: depth and accumulation; the random background is
    drawn per chunk); without a state it samples every cell."""
    jcfg, tcfg, method = setup["jcfg"], setup["tcfg"], setup["method"]
    jm, tm = setup["jm"], setup["tm"]
    occs = _occs(7)
    coords = np.stack(np.meshgrid(np.arange(H), np.arange(W), indexing="ij"),
                      -1).reshape(-1, 2).astype(np.float32) + 0.5
    idx = np.full(H * W, 1, np.int32)
    jrays = jcam.generate_rays(setup["jcams"], jnp.asarray(idx), jnp.asarray(coords))
    jout = jax.jit(lambda p, b: jm.get_outputs(
        jcfg, p, jnp.asarray(AABB), jrays, rng=None, train=False,
        occ_binary=b))(jax.tree_util.tree_map(jnp.asarray, setup["np_tree"]),
                       _jax_binary(jcfg, occs))
    background = _t(jax.random.uniform(jax.random.PRNGKey(0), (H * W, 3)))
    params = convert.params_from_jax(setup["np_tree"], device=CPU)
    cams = tcam.Cameras.create(**_camera_args(), device=CPU)
    rays = tcam.generate_rays(cams, _t(idx), _t(coords))
    aux = convert.aux_from_jax({"occs": occs}, device=CPU)
    with torch.no_grad():
        tout = tm.get_outputs(tcfg, params, _t(AABB), rays, background=background,
                              **tm.eval_kwargs(tcfg, aux))
    np.testing.assert_array_equal(tout["valid"].numpy(), np.asarray(jout["valid"]))
    assert 0.3 < float(np.asarray(jout["accumulation"]).mean()) < 0.999
    for k in ("rgb", "accumulation"):
        assert float(np.abs(_np(tout[k]) - np.asarray(jout[k])).max()) <= 1e-4, k
    off = np.abs(_np(tout["depth"]) - np.asarray(jout["depth"])) / np.asarray(jout["depth"])
    assert (off <= 1e-4).sum() >= 62
    with torch.no_grad():
        own = tm.get_outputs(tcfg, params, _t(AABB), rays,
                             **tm.eval_kwargs(tcfg, aux))
        every = tm.get_outputs(tcfg, params, _t(AABB), rays)
    for chunk, keys in ((64, ("rgb", "accumulation", "depth")),
                        (24, ("accumulation", "depth"))):
        image = render_camera(tcfg, params, cams, 1, chunk=chunk, device=CPU,
                              aabb=AABB, model=tmc.model_names[method], aux=aux)
        assert image["rgb"].shape == (H, W, 3) and image["depth"].shape == (H, W)
        for k in keys:
            torch.testing.assert_close(image[k].reshape(H * W, -1),
                                       own[k].reshape(H * W, -1), rtol=1e-5,
                                       atol=1e-6)
    image = render_camera(tcfg, params, cams, 1, device=CPU, aabb=AABB,
                          model=tmc.model_names[method])
    torch.testing.assert_close(image["accumulation"].reshape(-1),
                               every["accumulation"], rtol=1e-5, atol=1e-6)
    assert int(every["num_samples_per_ray"].min()) == 12
    with pytest.raises(ValueError, match="takes no state"):
        render_camera(tcfg, params, cams, 1, device=CPU, aabb=AABB,
                      model="nerfacto", aux=aux)


# ---------------------------------------------------------------------------
# fields
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("contraction", ["aabb", "un_bounded_sphere",
                                         "un_bounded_tanh"])
def test_instant_ngp_density_matches_jax(contraction):
    """instant_ngp_density (density and geo features) under each
    normalisation, at points inside the scene box for the box's (a point
    outside it has negative lattice coordinates, whose hash rows are not
    the JAX package's; the sampler keeps samples inside the box) and
    inside and outside it for the contractions: 1e-4 of the max (bf16 MLP
    operands on a rounding boundary)."""
    jfc = jif.InstantNGPFieldConfig(max_res=128, log2_hashmap_size=12,
                                    contraction_type=contraction)
    tfc = tif.InstantNGPFieldConfig(**dataclasses.asdict(jfc))
    assert tfc.grid == dataclasses.replace(tfc.grid, hash_scheme="zline")
    jp = jax.tree_util.tree_map(np.asarray, jif.init_instant_ngp_field(
        jax.random.PRNGKey(1), jfc))
    jp["grid"]["embeddings"] = jp["grid"]["embeddings"] * 3000.0
    rng = np.random.default_rng(40)
    extent = 1.45 if contraction == "aabb" else 2.5
    pos = rng.uniform(-extent, extent, (500, 3)).astype(np.float32)
    jd, jgeo = jif.instant_ngp_density(jfc, jax.tree_util.tree_map(jnp.asarray, jp),
                                       jnp.asarray(AABB), jnp.asarray(pos))
    td, tgeo = tif.instant_ngp_density(tfc, convert.params_from_jax(jp, device=CPU),
                                       _t(AABB), _t(pos))
    assert tgeo.shape == (500, 15)
    assert _rel(td, jd) <= 1e-4 and _rel(tgeo, jgeo) <= 1e-4


@pytest.mark.parametrize("mode", ["train", "eval", "no embedding"])
def test_instant_ngp_rgb_matches_jax(mode):
    """The colour head: SH degree 4 of the directions, geo features and
    the appearance embedding (the camera's row in training, the mean row
    outside it; none when off): 1e-4 absolute on sigmoid outputs."""
    jfc = jif.InstantNGPFieldConfig(
        max_res=128, log2_hashmap_size=12, num_images=N_CAMS,
        use_appearance_embedding=mode != "no embedding")
    tfc = tif.InstantNGPFieldConfig(**dataclasses.asdict(jfc))
    jp = jax.tree_util.tree_map(np.asarray, jif.init_instant_ngp_field(
        jax.random.PRNGKey(2), jfc))
    rng = np.random.default_rng(41)
    geo = rng.standard_normal((300, 15)).astype(np.float32)
    dirs = rng.standard_normal((300, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    cams = rng.integers(0, N_CAMS, 300).astype(np.int32)
    train = mode != "eval"
    want = jif.instant_ngp_rgb(jfc, jax.tree_util.tree_map(jnp.asarray, jp),
                               jnp.asarray(geo), jnp.asarray(dirs),
                               jnp.asarray(cams) if train else None, train)
    got = tif.instant_ngp_rgb(tfc, convert.params_from_jax(jp, device=CPU),
                              _t(geo), _t(dirs), _t(cams) if train else None, train)
    assert got.shape == (300, 3)
    assert float(np.abs(_np(got) - np.asarray(want)).max()) <= 1e-4


@pytest.mark.parametrize("view_dependent", [False, True])
def test_nerfplayer_ngp_field_matches_jax(view_dependent):
    """nerfplayer_ngp_density at points inside the box at times in [0, 1]
    (0 and 1 included), and the colour head (view-independent as
    registered, and with SH directions and the appearance embedding): 1e-4
    of the max for the density and geo features, 1e-4 absolute for rgb."""
    jfc = jpf.NerfplayerNGPFieldConfig(
        num_levels=4, temporal_dim=8, log2_hashmap_size=12, max_res=256,
        num_images=N_CAMS, disable_viewing_dependent=not view_dependent,
        use_appearance_embedding=view_dependent)
    tfc = tpf.NerfplayerNGPFieldConfig(**dataclasses.asdict(jfc))
    jp = jax.tree_util.tree_map(np.asarray, jpf.init_nerfplayer_ngp_field(
        jax.random.PRNGKey(3), jfc))
    jp["grid"]["embeddings"] = jp["grid"]["embeddings"] * 3000.0
    tp = convert.params_from_jax(jp, device=CPU)
    jp = jax.tree_util.tree_map(jnp.asarray, jp)
    rng = np.random.default_rng(42)
    pos = rng.uniform(-1.45, 1.45, (500, 3)).astype(np.float32)
    times = rng.uniform(0, 1, 500).astype(np.float32)
    times[:2] = [0.0, 1.0]
    jd, jgeo = jpf.nerfplayer_ngp_density(jfc, jp, jnp.asarray(AABB),
                                          jnp.asarray(pos), jnp.asarray(times))
    td, tgeo = tpf.nerfplayer_ngp_density(tfc, tp, _t(AABB), _t(pos), _t(times))
    assert _rel(td, jd) <= 1e-4 and _rel(tgeo, jgeo) <= 1e-4
    dirs = rng.standard_normal((500, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    cams = rng.integers(0, N_CAMS, 500).astype(np.int32)
    for train in (True, False):
        want = jpf.nerfplayer_ngp_rgb(jfc, jp, jgeo, jnp.asarray(dirs),
                                      jnp.asarray(cams) if train else None, train)
        got = tpf.nerfplayer_ngp_rgb(tfc, tp, tgeo.detach(), _t(dirs),
                                     _t(cams) if train else None, train)
        assert float(np.abs(_np(got) - np.asarray(want)).max()) <= 1e-4


# ---------------------------------------------------------------------------
# draws, refusals, configs, conversion
# ---------------------------------------------------------------------------

def test_draws_and_refusals(setup):
    """train_draws gives the [N, 1] jitter, the [N, 3] random background
    (none for a fixed colour) and, for nerfplayer-ngp, one index_list row;
    aux_draws the update's draws; update_aux leaves the state on a step
    that does not update.  A train forward without the draws, a
    nerfplayer-ngp loss without its TV row, rays without times and a field
    with position or time gradients are refused, and a batch with target
    depths gets JAX's depth loss; the protocol's proposal schedules are
    inert."""
    method, tcfg, tm = setup["method"], setup["tcfg"], setup["tm"]
    gen = torch.Generator().manual_seed(0)
    draws = tm.train_draws(tcfg, 5, gen, CPU)
    assert [tuple(j.shape) for j in draws["jitters"]] == [(5, 1)]
    random_bg = method != "instant-ngp-bounded"
    assert (draws["background"] is not None) == random_bg
    if random_bg:
        assert draws["background"].shape == (5, 3)
    if method == "nerfplayer-ngp":
        assert len(draws["tv_rows"]) == 1 and 0 <= int(draws["tv_rows"][0]) < 7
    d = tm.aux_draws(tcfg, 256, gen, CPU)
    assert d["jitter"].shape == (1024, 3) and d["cells"].shape == (512,)
    assert ("time" in d) == (method == "nerfplayer-ngp")
    aux = {"occs": torch.zeros(16**3)}
    assert tm.update_aux(tcfg, None, _t(AABB), 17, aux) is aux
    assert tm.proposal_anneal(tcfg, 5) == 1.0
    host = {"steps_since_update": 3}
    assert tm.host_static_kwargs(tcfg, 5, host) == {"train_proposal_networks": False}
    assert host == {"steps_since_update": 3}
    params = convert.params_from_jax(setup["np_tree"], device=CPU)
    cams = tcam.Cameras.create(**_camera_args(), device=CPU)
    rays = tcam.generate_rays(cams, torch.zeros(4, dtype=torch.int32),
                              torch.full((4, 2), 4.0))
    with pytest.raises(ValueError, match="jitters"):
        tm.get_outputs(tcfg, params, _t(AABB), rays, train=True)
    if random_bg:
        with pytest.raises(ValueError, match="background"):
            tm.get_outputs(tcfg, params, _t(AABB), rays, train=True,
                           jitters=[torch.rand(4, 1)])
    if method != "nerfplayer-ngp":
        return
    with torch.no_grad():
        out = tm.get_outputs(tcfg, params, _t(AABB), rays, train=True,
                             jitters=[torch.rand(4, 1)],
                             background=torch.rand(4, 3))
    with pytest.raises(ValueError, match="index_list row"):
        tm.get_loss_dict(tcfg, params, out, {"image": torch.zeros(4, 3)})
    # a batch with target depths gets JAX's depth loss on the same outputs
    # (the temporal TV off: it reads the params, not the outputs)
    quiet = dataclasses.replace(tcfg, temporal_tv_weight=0.0)
    jquiet = dataclasses.replace(setup["jcfg"], temporal_tv_weight=0.0)
    batch = {"image": torch.zeros(4, 3),
             "depth_image": torch.tensor([1.0, 0.0, 2.5, 3.0])}
    jout = {k: (jrays.RaySamples(**{
                f.name: (getattr(v, f.name) if f.name == "spacing"
                         else None if getattr(v, f.name) is None
                         else jnp.asarray(getattr(v, f.name).numpy()))
                for f in dataclasses.fields(v)})
                if k == "ray_samples" else jnp.asarray(v.numpy()))
            for k, v in out.items()}
    want = setup["jm"].get_loss_dict(
        jquiet, None, jout, {k: jnp.asarray(v.numpy()) for k, v in batch.items()},
        None, train=True)
    got = tm.get_loss_dict(quiet, params, out, batch)
    assert set(got) == set(want) == {"rgb_loss", "depth_loss"}
    for k in want:
        assert _rel(got[k], want[k]) <= 1e-5, k
    with pytest.raises(ValueError, match="ray times"):
        tm.get_outputs(tcfg, params, _t(AABB), rays.replace(times=None))
    with pytest.raises(NotImplementedError):
        tpn.Config(detached_inputs=False).field_config()


def test_train_configs_copy_registered_occupancy_methods():
    """The port's instant-ngp, instant-ngp-bounded and nerfplayer-ngp model
    configs, optimizers (Adam, eps 1e-15 / 1e-15 / 1e-12, f32 moments, no
    schedule), camera optimizer (off) and rays per batch (8192) equal the
    JAX registry's; the static grid has 6,098,120 rows of 2, the temporal
    grid 1,698,432 rows of 66 (112,096,512 entries)."""
    from soccernerfs_tpu_torch.ops.hash_grid import level_layout

    for method, model in (("instant-ngp", "instant_ngp"),
                          ("instant-ngp-bounded", "instant_ngp"),
                          ("nerfplayer-ngp", "nerfplayer_ngp")):
        ref = method_configs[method]
        cfg = tmc.model_configs[method]
        assert dataclasses.asdict(cfg) == dataclasses.asdict(ref.pipeline.model)
        assert tmc.model_names[method] == ref.pipeline.model_name == model
        got = tmc.optimizer_configs[method]
        assert list(got) == list(ref.optimizers) == ["fields"]
        mine = dataclasses.asdict(got["fields"]["optimizer"])
        theirs = dataclasses.asdict(ref.optimizers["fields"]["optimizer"])
        assert mine == {k: theirs[k] for k in mine}
        assert mine["eps"] == (1e-12 if method == "nerfplayer-ngp" else 1e-15)
        assert mine["moment_dtype"] is None
        assert got["fields"]["scheduler"] is ref.optimizers["fields"]["scheduler"] is None
        assert (tmc.camera_optimizer_configs[method].mode
                == ref.pipeline.datamanager.camera_optimizer.mode == "off")
        assert (tmc.train_num_rays_per_batch[method]
                == ref.pipeline.datamanager.train_num_rays_per_batch == 8192)
        grid = cfg.field_config().grid
        rows = level_layout(grid)[0][-1]
        assert (rows, grid.row_channels) == ((1_698_432, 66)
                                             if model == "nerfplayer_ngp"
                                             else (6_098_120, 2))
    assert get_model("instant_ngp") is tin and get_model("nerfplayer_ngp") is tpn


def test_params_round_trip_and_seeded_tree(setup):
    """params_from_jax keeps the JAX tree's structure and values, and
    aux_from_jax the state's; seeded_params builds the same structure and
    shapes without JAX, and so does the port's own init."""
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
    assert list(params) == ["fields"]
    assert set(params["fields"]) == {"grid", "mlp_base", "mlp_head"}
    for tree in (convert.seeded_params(tcfg, 3, N_CAMS),
                 setup["tm"].init(tcfg, N_CAMS, torch.Generator().manual_seed(0))):
        got = {}
        _walk(tree, lambda path, x: got.__setitem__(path, tuple(x.shape)))
        assert got == shapes
    occs = np.asarray(jin.init_aux(setup["jcfg"])["occs"])
    aux = convert.aux_from_jax({"occs": occs}, device=CPU)
    assert torch.equal(aux["occs"], setup["tm"].init_aux(tcfg)["occs"])
    assert len(tree_leaves(params)) == len(shapes)
