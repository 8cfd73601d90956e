"""The port's nerfacto slice (soccernerfs_tpu_torch) against the JAX package
on the CPU: the field and proposal densities, the SH / appearance colour
head, the lie-group exponential maps and pose-corrected rays, Adam with f32
moments and with coupled weight decay, the parameter conversion, one eval
chunk, and one whole train step with the camera optimizer on (loss terms
and every gradient, ``camera_opt`` included, before the update).

A small config: 3 hash levels to 64 at 2^13 rows behind proposal grids of
3 levels to 32 and 64 at 2^12 rows (level 0 dense, the rest hashed), MLPs
of 16 and 8, (12, 8) + 6 samples, 96 rays from three cameras.  Torch cannot
reproduce JAX's PRNG streams, so the tests make JAX's own draws and hand
them to the port.  Inputs are made with numpy from a seed; every tolerance
is stated with its reason.
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
from soccernerfs_tpu.core import lie_groups as jlie
from soccernerfs_tpu.engine import optimizers as jopt
from soccernerfs_tpu.fields import nerfacto as jf
from soccernerfs_tpu.models import nerfacto as jn
from soccernerfs_tpu_torch import convert
from soccernerfs_tpu_torch.configs import method_configs as tmc
from soccernerfs_tpu_torch.core import camera_optimizer as tco
from soccernerfs_tpu_torch.core import cameras as tcam
from soccernerfs_tpu_torch.core import lie_groups as tlie
from soccernerfs_tpu_torch.engine import optimizers as topt
from soccernerfs_tpu_torch.engine.render import render_camera
from soccernerfs_tpu_torch.engine.trainer import TrainStep
from soccernerfs_tpu_torch.fields import nerfacto as tf
from soccernerfs_tpu_torch.models import get_model
from soccernerfs_tpu_torch.models import nerfacto as tn
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
SMALL = dict(
    num_levels=3, max_res=64, log2_hashmap_size=13, hidden_dim=16,
    hidden_dim_color=16, num_proposal_samples_per_ray=(12, 8),
    num_nerf_samples_per_ray=6,
    proposal_net_args_list=(
        {"hidden_dim": 8, "log2_hashmap_size": 12, "num_levels": 3, "max_res": 32},
        {"hidden_dim": 8, "log2_hashmap_size": 12, "num_levels": 3, "max_res": 64},
    ),
    eval_num_rays_per_chunk=64,
)
AABB = np.array([[-1.5] * 3, [1.5] * 3], np.float32)
H = W = 8
N_RAYS = 96
N_CAMS = 3
CAM_OPT = dict(mode="SO3xR3")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rel(got, want) -> float:
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


def _camera_args():
    c2w = np.tile(np.eye(3, 4, dtype=np.float32)[None], (N_CAMS, 1, 1))
    c2w[:, :, 3] = [[0.2, -0.1, 3.0], [-0.3, 0.2, 2.8], [0.0, 0.1, 3.2]]
    return dict(camera_to_worlds=c2w, fx=7.0, fy=7.5, cx=4.1, cy=3.9,
                width=W, height=H)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "cam_idx": rng.integers(0, N_CAMS, N_RAYS).astype(np.int32),
        "coords": rng.uniform(0, H, (N_RAYS, 2)).astype(np.float32),
        "image": rng.uniform(0, 1, (N_RAYS, 3)).astype(np.float32),
    }


def _jax_jitters(cfg, key, n):
    """get_outputs' draws from its key: split into (sampling, background),
    the sampling key into one key per level, one uniform per ray and level
    (a single jitter)."""
    rng_sample, _rng_bg = jax.random.split(key)
    keys = jax.random.split(rng_sample, cfg.num_proposal_iterations + 1)
    assert cfg.use_single_jitter
    return [_t(jax.random.uniform(k, (n, 1))) for k in keys]


def _walk(tree, fn, path=()):
    if isinstance(tree, dict):
        return {k: _walk(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_walk(v, fn, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = jn.Config(**SMALL), tn.Config(**SMALL)
    rng = np.random.default_rng(7)

    def lift(path, x):
        # the init's tables are U(-1e-4, 1e-4): scale them to +-0.3 so the
        # encoding, not the MLP biases alone, shapes densities and gradients
        x = np.asarray(x)
        return x * 3000.0 if path[-1] == "embeddings" else x

    np_tree = _walk(jax.tree_util.tree_map(
        np.asarray, jn.init(jax.random.PRNGKey(0), jcfg, N_CAMS)), lift)
    np_tree["camera_opt"] = {"pose_adjustment": (
        rng.standard_normal((N_CAMS, 6)) * 0.02).astype(np.float32)}
    jcams = jcam.Cameras.create(**_camera_args())
    aabb = jnp.asarray(AABB)
    jcam_cfg = jco.CameraOptimizerConfig(**CAM_OPT)

    @functools.partial(jax.jit, static_argnums=(3,))
    def jax_step(params, batch, key, flag, step):
        """The loss_fn of the JAX Trainer's shard_loss_and_grads, with the
        step's schedules (anneal traced, the proposal flag static)."""

        def loss_fn(p):
            cam_opt = jco.apply_camera_optimizer(jcam_cfg, p.get("camera_opt"),
                                                 batch["cam_idx"])
            rays = jcam.generate_rays(jcams, batch["cam_idx"], batch["coords"],
                                      cam_opt)
            outputs = jn.get_outputs(
                jcfg, p, aabb, rays, rng=key, train=True,
                anneal=jn._kp.proposal_anneal(jcfg, step),
                train_proposal_networks=flag)
            metrics = jn.get_metrics_dict(jcfg, outputs, batch, step)
            loss_dict = jn.get_loss_dict(jcfg, p, outputs, batch, metrics,
                                         train=True)
            return functools.reduce(jnp.add, loss_dict.values()), (loss_dict,
                                                                   metrics)

        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    return dict(jcfg=jcfg, tcfg=tcfg, np_tree=np_tree, jax_step=jax_step,
                jcams=jcams)


def _trainer(tcfg):
    cams = tcam.Cameras.create(**_camera_args(), device=CPU)
    return TrainStep(tcfg, cams, AABB, tmc.optimizer_configs["nerfacto"],
                     device=CPU, model="nerfacto",
                     camera_optimizer=tco.CameraOptimizerConfig(**CAM_OPT))


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flag", [True, False])
def test_train_step_matches_jax(setup, flag):
    """One train step at step 300 (anneal 0.845) with the SO3xR3 camera
    optimizer on and non-zero pose adjustments, proposal update on and off:
    the loss, each loss term, PSNR and the distortion metric, and the
    gradient of every parameter (hash tables, MLPs, appearance embedding,
    ``camera_opt/pose_adjustment``) before the update, against
    jax.value_and_grad of the JAX step with the same params, batch and
    draws.

    Tolerances.  The loss terms: 1e-4 relative (f32 sums in another order,
    bf16 MLP operands that round the other way on a rounding boundary, the
    PDF resampling's magnification of CDF rounding).  The gradients: per
    tensor, 2e-2 of its max |grad|, the K-Planes step's limit: a flipped
    bf16 rounding of an MLP operand is a 2^-8 step that positions, and
    through them the pose gradient, inherit.  On non-update steps JAX
    returns zeros for the proposal networks; the port returns no gradient
    (None), which the optimizer takes as zeros."""
    jcfg, tcfg = setup["jcfg"], setup["tcfg"]
    step = 300
    batch = _batch()
    key = jax.random.PRNGKey(11)
    (jloss, (jld, jmet)), jgrads = setup["jax_step"](
        jax.tree_util.tree_map(jnp.asarray, setup["np_tree"]),
        {k: jnp.asarray(v) for k, v in batch.items()}, key, flag, step)

    trainer = _trainer(tcfg)
    state = trainer.init_state(convert.params_from_jax(setup["np_tree"],
                                                       device=CPU))
    state.step = step
    loss, ld, met, grads = trainer.loss_and_grads(
        state, {k: _t(v) for k, v in batch.items()},
        train_proposal_networks=flag, jitters=_jax_jitters(tcfg, key, N_RAYS))

    assert list(ld) == ["rgb_loss", "interlevel_loss", "distortion_loss"]
    assert set(jld) == set(ld) and set(jmet) == set(met) == {"psnr", "distortion"}
    assert _rel(loss, jloss) <= 1e-4
    for k in jld:
        assert _rel(ld[k], jld[k]) <= 1e-4, k
    for k in jmet:
        assert _rel(met[k], jmet[k]) <= 1e-4, k
        assert not met[k].requires_grad
    names = []
    _walk(state.params, lambda path, x: names.append(path))
    tgrads = dict(zip(names, grads))
    jflat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert len(jflat) == len(names)
    checked = 0
    for path, jg in jflat:
        name = tuple(p.key if hasattr(p, "key") else p.idx for p in path)
        g = tgrads[name]
        if g is None:
            assert not flag and name[0] == "proposal_networks", name
            assert np.abs(np.asarray(jg)).max() == 0.0, name
            continue
        assert tuple(g.shape) == jg.shape, name
        assert np.abs(np.asarray(jg)).max() > 0.0, name
        assert _rel(g, jg) <= 2e-2, (name, _rel(g, jg))
        checked += 1
    # on non-update steps the two proposal fields (table + 2 x 2 MLP leaves
    # each) get none
    assert checked == (len(jflat) if flag else len(jflat) - 10)
    assert ("camera_opt", "pose_adjustment") in tgrads


def test_scatter_runs_every_step_and_proposals_only_on_update_steps(
        setup, monkeypatch):
    """A short loop through train_iteration from step 0 (every step updates
    the proposals) and from step 10,000 (an update every sixth step): the
    table gradient (scatter_add_rows' plain version here) runs once for
    the main field on every step and once more per proposal field on the
    update steps; parameters of all three groups move, the camera
    optimizer's included."""
    calls = []
    plain = sk.scatter_add_rows_plain

    def counted(*a, **kw):
        calls.append(kw["rows"])
        return plain(*a, **kw)

    monkeypatch.setattr(sk, "scatter_add_rows_plain", counted)
    tcfg = setup["tcfg"]
    trainer = _trainer(tcfg)
    tree = {k: v for k, v in setup["np_tree"].items() if k != "camera_opt"}
    state = trainer.init_state(convert.params_from_jax(tree, device=CPU))
    pose = state.params["camera_opt"]["pose_adjustment"]
    assert pose.shape == (N_CAMS, 6) and float(pose.detach().abs().max()) == 0.0
    assert state.opt_state["fields"].mu[0].dtype == torch.float32
    batch = {k: _t(v) for k, v in _batch(1).items()}
    gen = torch.Generator().manual_seed(0)
    watch = {g: tree_leaves(state.params[g])[0] for g in state.params}
    main_rows = state.params["fields"]["grid"]["embeddings"].shape[0]
    for start, n in ((0, 3), (10_000, 8)):
        state.step, state.steps_since_update = start, 0
        host = {}
        for i in range(n):
            del calls[:]
            before = {g: w.detach().clone() for g, w in watch.items()}
            metrics = trainer.train_iteration(state, batch, gen)
            updated = tn.host_static_kwargs(tcfg, start + i, host)[
                "train_proposal_networks"]
            assert len(calls) == (3 if updated else 1)
            assert calls.count(main_rows) == 1
            assert np.isfinite(float(metrics["Train Loss"]))
            for g, w in watch.items():
                # the proposal tables only decay their moments on
                # non-update steps; they move all the same
                assert not torch.equal(before[g], w.detach()), g
        assert state.step == start + n


def test_training_lowers_the_loss(setup):
    """Sixty steps on one batch whose target is one colour: the rgb loss
    falls below a third of its start, and the parameters stay finite."""
    trainer = _trainer(setup["tcfg"])
    state = trainer.init_state(convert.params_from_jax(setup["np_tree"],
                                                       device=CPU))
    state.step = 600
    batch = {k: _t(v) for k, v in _batch(2).items()}
    batch["image"][:] = torch.tensor([0.9, 0.1, 0.5])
    gen = torch.Generator().manual_seed(1)
    losses = [float(trainer.train_iteration(state, batch, gen)["rgb_loss"])
              for _ in range(60)]
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) / 3
    assert all(bool(torch.isfinite(p).all()) for p in tree_leaves(state.params))


def test_kplanes_with_the_camera_optimizer_still_raises():
    """The K-Planes field has no position backward: with the camera
    optimizer on, its step raises rather than dropping the pose gradient."""
    from soccernerfs_tpu_torch.models import kplanes as tk

    cfg = tk.Config(spacetime_resolution=(8, 8, 8), multiscale_res=(1,),
                    feature_dim=8, proposal_net_args_list=(
                        {"feature_dim": 8, "resolution": (8, 8, 8)},),
                    num_proposal_iterations=1,
                    num_proposal_samples_per_ray=(8,),
                    num_nerf_samples_per_ray=4)
    cams = tcam.Cameras.create(**_camera_args(), device=CPU)
    groups = dict(tmc.optimizer_configs["k-planes"],
                  camera_opt=tmc.optimizer_configs["nerfacto"]["camera_opt"])
    trainer = TrainStep(cfg, cams, AABB, groups, device=CPU,
                        camera_optimizer=tco.CameraOptimizerConfig(**CAM_OPT))
    state = trainer.init_state(tk.init(cfg, generator=torch.Generator().manual_seed(0)))
    with pytest.raises(ValueError, match="require grad"):
        trainer.train_iteration(state, {k: _t(v) for k, v in _batch().items()},
                                torch.Generator().manual_seed(0))


# ---------------------------------------------------------------------------
# eval
# ---------------------------------------------------------------------------

def test_eval_chunk_and_render_camera_match_jax(setup):
    """get_outputs(train=False) on one camera's 64 pixels against the JAX
    package (mean appearance embedding, no jitter): rgb and accumulation
    to 1e-4 absolute (f32 sums, bf16 MLP operands), median depth to 1e-4
    relative on at least 62 of 64 rays (it jumps where the cumulative
    weight sits at 0.5).  render_camera's chunked image equals one chunk of
    all its pixels."""
    jcfg, tcfg = setup["jcfg"], setup["tcfg"]
    jcams = setup["jcams"]
    coords = np.stack(np.meshgrid(np.arange(H), np.arange(W), indexing="ij"),
                      -1).reshape(-1, 2).astype(np.float32) + 0.5
    idx = np.full(H * W, 1, np.int32)
    jrays = jcam.generate_rays(jcams, jnp.asarray(idx), jnp.asarray(coords))
    jout = jax.jit(lambda p: jn.get_outputs(
        jcfg, p, jnp.asarray(AABB), jrays, rng=None, train=False))(
        jax.tree_util.tree_map(jnp.asarray, setup["np_tree"]))
    params = convert.params_from_jax(setup["np_tree"], device=CPU)
    cams = tcam.Cameras.create(**_camera_args(), device=CPU)
    with torch.no_grad():
        tout = tn.get_outputs(tcfg, params, _t(AABB),
                              tcam.generate_rays(cams, _t(idx), _t(coords)))
    for k in ("rgb", "accumulation"):
        assert float(np.abs(_np(tout[k]) - np.asarray(jout[k])).max()) <= 1e-4, k
    for k in ("depth", "prop_depth_0", "prop_depth_1"):
        off = np.abs(_np(tout[k]) - np.asarray(jout[k])) / np.asarray(jout[k])
        assert (off <= 1e-4).sum() >= 62, k
    image = render_camera(tcfg, params, cams, 1, chunk=24, device=CPU, aabb=AABB,
                          model="nerfacto")
    assert image["rgb"].shape == (H, W, 3) and image["depth"].shape == (H, W)
    for k in ("rgb", "accumulation", "depth"):
        torch.testing.assert_close(image[k].reshape(H * W, -1),
                                   tout[k].reshape(H * W, -1), rtol=1e-5,
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# fields
# ---------------------------------------------------------------------------

def test_densities_match_jax(setup):
    """nerfacto_density (density and geo features) and both proposal
    fields' densities at points inside and far outside the unit cube (the
    contraction's two branches): 1e-4 of the max (bf16 MLP operands on a
    rounding boundary; the encodings themselves agree to 1e-6)."""
    jcfg, tcfg = setup["jcfg"], setup["tcfg"]
    rng = np.random.default_rng(30)
    pos = (rng.standard_normal((500, 3)) * np.array([0.6, 3.0, 20.0])
           ).astype(np.float32)
    jp = jax.tree_util.tree_map(jnp.asarray, setup["np_tree"])
    tp = convert.params_from_jax(setup["np_tree"], device=CPU)
    jd, jgeo = jf.nerfacto_density(jcfg.field_config(), jp["fields"],
                                   jnp.asarray(AABB), jnp.asarray(pos))
    td, tgeo = tf.nerfacto_density(tcfg.field_config(), tp["fields"], _t(AABB),
                                   _t(pos))
    assert _rel(td, jd) <= 1e-4 and _rel(tgeo, jgeo) <= 1e-4
    assert tgeo.shape == (500, 15)
    for (ji, jd_cfg), (ti, td_cfg) in zip(jcfg.density_field_configs(),
                                          tcfg.density_field_configs()):
        assert ji == ti and dataclasses.asdict(jd_cfg) == dataclasses.asdict(td_cfg)
        want = jf.hash_density_field_density(
            jd_cfg, jp["proposal_networks"][f"proposal_{ji}"], jnp.asarray(AABB),
            jnp.asarray(pos))
        got = tf.hash_density_field_density(
            td_cfg, tp["proposal_networks"][f"proposal_{ti}"], _t(AABB), _t(pos))
        assert _rel(got, want) <= 1e-4
    # the uncontracted variant normalises by the scene box
    j2 = dataclasses.replace(jcfg.field_config(), disable_scene_contraction=True)
    t2 = dataclasses.replace(tcfg.field_config(), disable_scene_contraction=True)
    inside = (pos / np.abs(pos).max() * 1.4).astype(np.float32)
    jd2, _ = jf.nerfacto_density(j2, jp["fields"], jnp.asarray(AABB),
                                 jnp.asarray(inside))
    td2, _ = tf.nerfacto_density(t2, tp["fields"], _t(AABB), _t(inside))
    assert _rel(td2, jd2) <= 1e-4


@pytest.mark.parametrize("mode", ["train", "eval mean", "eval zeros"])
def test_rgb_matches_jax(setup, mode):
    """The colour head: SH degree 4 of the directions, geo features and the
    appearance embedding (the camera's row in training; the mean row or
    zeros outside it): 1e-4 absolute on sigmoid outputs."""
    rng = np.random.default_rng(31)
    geo = rng.standard_normal((300, 15)).astype(np.float32)
    dirs = rng.standard_normal((300, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    cams = rng.integers(0, N_CAMS, 300).astype(np.int32)
    average = mode == "eval mean"
    jfc = dataclasses.replace(setup["jcfg"].field_config(),
                              use_average_appearance_embedding=average)
    tfc = dataclasses.replace(setup["tcfg"].field_config(),
                              use_average_appearance_embedding=average)
    jp = jax.tree_util.tree_map(jnp.asarray, setup["np_tree"]["fields"])
    tp = convert.params_from_jax(setup["np_tree"]["fields"], device=CPU)
    train = mode == "train"
    want = jf.nerfacto_rgb(jfc, jp, jnp.asarray(geo), jnp.asarray(dirs),
                           jnp.asarray(cams) if train else None, train)
    got = tf.nerfacto_rgb(tfc, tp, _t(geo), _t(dirs),
                          _t(cams) if train else None, train)
    assert got.shape == (300, 3)
    assert float(np.abs(_np(got) - np.asarray(want)).max()) <= 1e-4


def test_unported_branches_are_refused():
    with pytest.raises(NotImplementedError):
        tn.Config(predict_normals=True)
    with pytest.raises(NotImplementedError):
        tf.NerfactoFieldConfig(use_pred_normals=True)
    with pytest.raises(NotImplementedError):
        tn.Config(background_color="random")
    with pytest.raises(KeyError):
        get_model("no_such_model")
    assert get_model("nerfacto") is tn


# ---------------------------------------------------------------------------
# camera optimizer
# ---------------------------------------------------------------------------

def test_exp_maps_match_jax():
    """exp_map_SO3xR3 and exp_map_SE3 on small, near-zero and large
    tangents (both sides of SE3's Taylor guard at 1e-2 and of SO3xR3's
    clamp at 1e-4), values and the gradient of a weighted sum: 1e-6."""
    rng = np.random.default_rng(32)
    tangent = (rng.standard_normal((12, 6))
               * np.array([1e-4, 5e-3, 2e-2, 0.3, 1.0, 2.5]).repeat(2)[:, None]
               ).astype(np.float32)
    tangent[0] = 0.0
    cot = rng.standard_normal((12, 3, 4)).astype(np.float32)
    for jfn, tfn in ((jlie.exp_map_SO3xR3, tlie.exp_map_SO3xR3),
                     (jlie.exp_map_SE3, tlie.exp_map_SE3)):
        want, vjp = jax.vjp(jfn, jnp.asarray(tangent))
        x = _t(tangent).requires_grad_(True)
        got = tfn(x)
        got.backward(_t(cot))
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(_np(x.grad), np.asarray(vjp(jnp.asarray(cot))[0]),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["SO3xR3", "SE3", "off"])
def test_pose_corrected_rays_match_jax(mode):
    """apply_camera_optimizer + generate_rays with the correction: origins,
    directions and pixel areas to 1e-6, and the gradient of a weighted sum
    of origins and directions w.r.t. the pose adjustments to 1e-5 of its
    max.  ``off`` gives no correction and the uncorrected rays."""
    rng = np.random.default_rng(33)
    adj = (rng.standard_normal((N_CAMS, 6)) * 0.05).astype(np.float32)
    batch = _batch(4)
    cot_o = rng.standard_normal((N_RAYS, 3)).astype(np.float32)
    cot_d = rng.standard_normal((N_RAYS, 3)).astype(np.float32)
    jcfg, tcfg = jco.CameraOptimizerConfig(mode=mode), tco.CameraOptimizerConfig(mode=mode)
    jcams = jcam.Cameras.create(**_camera_args())
    tcams = tcam.Cameras.create(**_camera_args(), device=CPU)

    def jrays(a):
        c = jco.apply_camera_optimizer(jcfg, {"pose_adjustment": a},
                                       jnp.asarray(batch["cam_idx"]))
        return jcam.generate_rays(jcams, jnp.asarray(batch["cam_idx"]),
                                  jnp.asarray(batch["coords"]), c)

    ta = _t(adj).requires_grad_(True)
    corr = tco.apply_camera_optimizer(tcfg, {"pose_adjustment": ta},
                                      _t(batch["cam_idx"]))
    trays = tcam.generate_rays(tcams, _t(batch["cam_idx"]), _t(batch["coords"]), corr)
    want = jrays(jnp.asarray(adj))
    for name in ("origins", "directions", "pixel_area", "directions_norm"):
        np.testing.assert_allclose(_np(getattr(trays, name)),
                                   np.asarray(getattr(want, name)), rtol=1e-5,
                                   atol=1e-6)
    if mode == "off":
        assert corr is None
        return
    jg = jax.grad(lambda a: jnp.vdot(jrays(a).origins, cot_o)
                  + jnp.vdot(jrays(a).directions, cot_d))(jnp.asarray(adj))
    ((trays.origins * _t(cot_o)).sum() + (trays.directions * _t(cot_d)).sum()).backward()
    assert _rel(ta.grad, jg) <= 1e-5


def test_camera_optimizer_init_and_noise():
    """Zero adjustments; with noise stds, a frozen [N, 3, 4] pose_noise that
    composes in front of the correction as in the JAX package."""
    params = tco.init_camera_optimizer(tco.CameraOptimizerConfig(**CAM_OPT), 5)
    assert list(params) == ["pose_adjustment"]
    assert params["pose_adjustment"].shape == (5, 6)
    cfg = tco.CameraOptimizerConfig(mode="SE3", position_noise_std=0.1,
                                    orientation_noise_std=0.05)
    params = tco.init_camera_optimizer(cfg, 5, torch.Generator().manual_seed(0))
    assert params["pose_noise"].shape == (5, 3, 4)
    rng = np.random.default_rng(34)
    adj = (rng.standard_normal((5, 6)) * 0.05).astype(np.float32)
    idx = np.array([4, 0, 2, 2], np.int32)
    got = tco.apply_camera_optimizer(
        cfg, {"pose_adjustment": _t(adj), "pose_noise": params["pose_noise"]},
        _t(idx))
    want = jco.apply_camera_optimizer(
        jco.CameraOptimizerConfig(mode="SE3", position_noise_std=0.1,
                                  orientation_noise_std=0.05),
        {"pose_adjustment": jnp.asarray(adj),
         "pose_noise": jnp.asarray(_np(params["pose_noise"]))}, jnp.asarray(idx))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the optimizer, the configs, the conversion
# ---------------------------------------------------------------------------

def _assert_same_optimizer(mine, theirs):
    """The port's Adam config equals the JAX one on every field it has,
    and the JAX one uses none of the options the port leaves out."""
    ref = dataclasses.asdict(theirs)
    got = dataclasses.asdict(mine)
    assert got == {k: ref[k] for k in got}
    assert type(theirs) is jopt.AdamOptimizerConfig
    assert {k: v for k, v in ref.items() if k not in got} == {
        "max_norm": None, "kind": "adam", "nu_moment_dtype": "float32"}


@pytest.mark.parametrize("group", ["fields", "camera_opt"])
def test_adam_update_matches_optax(group):
    """Four updates of the registry's nerfacto group optimizers fed the
    same gradients as the JAX chain: ``fields`` is scale_by_adam (f32
    moments, eps 1e-15) + scale_by_schedule(-lr); ``camera_opt`` is
    add_decayed_weights(1e-2) + scale_by_adam (eps 1e-8) +
    scale_by_schedule.  Params and both moments to 1e-6 relative.  A
    gradient of None is a zero gradient: the moments still decay and the
    entry still moves."""
    gcfg = tmc.optimizer_configs["nerfacto"][group]
    jgcfg = method_configs["nerfacto"].optimizers[group]
    _assert_same_optimizer(gcfg["optimizer"], jgcfg["optimizer"])
    assert gcfg["scheduler"] is None and jgcfg["scheduler"] is None
    rng = np.random.default_rng(52)
    params = [rng.uniform(-1e-4, 1e-4, (40, 2)).astype(np.float32),
              rng.standard_normal((7,)).astype(np.float32)]
    jtx = jopt.build_group_optimizer(jgcfg["optimizer"], jgcfg["scheduler"])
    jp = [jnp.asarray(p) for p in params]
    jstate = jtx.init(jp)
    tp = [_t(p) for p in params]
    opt = gcfg["optimizer"]
    tstate = topt.adam_init(opt, tp)
    sched = topt.schedule_fn(gcfg["scheduler"], opt.lr)
    for i in range(4):
        grads = [rng.standard_normal(p.shape).astype(np.float32) * 10.0 ** -i
                 for p in params]
        grads[0][::2] = 0.0           # table rows that no sample touched
        if i == 2:
            grads[1] = np.zeros_like(grads[1])
        upd, jstate = jtx.update([jnp.asarray(g) for g in grads], jstate, jp)
        jp = optax.apply_updates(jp, upd)
        before = [p.clone() for p in tp]
        topt.adam_update(opt, sched, tstate, tp,
                         [None if i == 2 and k == 1 else _t(g)
                          for k, g in enumerate(grads)])
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-6, atol=1e-9)
        if i == 2:
            assert not torch.equal(before[1], tp[1])
    adam = [s for s in jstate if hasattr(s, "mu")][0]
    for mine, theirs in ((tstate.mu, adam.mu), (tstate.nu, adam.nu)):
        for a, b in zip(mine, theirs):
            assert a.dtype == torch.float32 and b.dtype == jnp.float32
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-12)


def test_train_configs_copy_registered_nerfacto():
    """The port's nerfacto model config, optimizers, camera optimizer and
    rays per batch equal the JAX registry's, field by field."""
    ref = method_configs["nerfacto"]
    assert dataclasses.asdict(tmc.model_configs["nerfacto"]) == dataclasses.asdict(
        ref.pipeline.model)
    assert tmc.model_names["nerfacto"] == ref.pipeline.model_name
    got = tmc.optimizer_configs["nerfacto"]
    assert list(got) == list(ref.optimizers)
    for group, gcfg in ref.optimizers.items():
        _assert_same_optimizer(got[group]["optimizer"], gcfg["optimizer"])
        assert got[group]["scheduler"] is None and gcfg["scheduler"] is None
    assert dataclasses.asdict(tmc.camera_optimizer_configs["nerfacto"]) == (
        dataclasses.asdict(ref.pipeline.datamanager.camera_optimizer))
    assert (tmc.camera_optimizer_configs["k-planes"].mode
            == method_configs["k-planes"].pipeline.datamanager.camera_optimizer.mode)
    assert (tmc.train_num_rays_per_batch["nerfacto"]
            == ref.pipeline.datamanager.train_num_rays_per_batch)
    with pytest.raises(ValueError):
        topt.AdamOptimizerConfig(moment_dtype="float16")


def test_params_round_trip_and_seeded_tree(setup):
    """params_from_jax keeps the JAX tree's structure and values (with the
    trainer's camera_opt group); seeded_params builds the same structure
    and shapes without JAX; the port's own init does too."""
    np_tree = setup["np_tree"]
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
    assert set(params) == {"fields", "proposal_networks", "camera_opt"}
    for tree in (convert.seeded_params(setup["tcfg"], 3, N_CAMS),
                 tn.init(setup["tcfg"], N_CAMS, torch.Generator().manual_seed(0))):
        got = {}
        _walk(tree, lambda path, x: got.__setitem__(path, tuple(x.shape)))
        assert got == {k: v for k, v in shapes.items() if k[0] != "camera_opt"}
    table = convert.seeded_params(setup["tcfg"], 3, N_CAMS, grid_std=0.5)[
        "fields"]["grid"]["embeddings"]
    assert 0.4 < float(np.abs(table).max()) <= 0.5
