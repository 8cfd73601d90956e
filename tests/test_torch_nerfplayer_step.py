"""The port's nerfplayer-nerfacto slice (soccernerfs_tpu_torch) against the
JAX package on the CPU: the temporal field and proposal densities, the
colour head, one eval chunk with the random background, one whole train
step (loss terms, the temporal TV included, and every gradient before the
update, with the proposal update on and off), Adam with the registry's
cosine schedule, the registry copy and the parameter conversion.

A small config: temporal grids of 3 levels with 8 temporal channels (10
per row) to 1024 at 2^13 rows (level 0 dense, the rest hashed, xor),
behind proposal grids of 3 levels with 6 temporal channels to 32 and 64
at 2^12 rows (zline), MLPs of 16 and 8, (12, 8) + 6 samples, 96 rays from
three cameras at three times, the scene box as collider.  Torch cannot
reproduce JAX's PRNG streams, so the tests make JAX's own draws (jitters,
background, the temporal TV's rows) and hand them to the port.  Inputs are
made with numpy from a seed; every tolerance is stated with its reason.
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
from soccernerfs_tpu.fields import nerfplayer_nerfacto as jf
from soccernerfs_tpu.models import nerfplayer_nerfacto as jn
from soccernerfs_tpu.ops import hash_grid as jh
from soccernerfs_tpu.ops import losses as jL
from soccernerfs_tpu_torch import convert
from soccernerfs_tpu_torch.configs import method_configs as tmc
from soccernerfs_tpu_torch.core import cameras as tcam
from soccernerfs_tpu_torch.engine import optimizers as topt
from soccernerfs_tpu_torch.engine.render import render_camera
from soccernerfs_tpu_torch.engine.trainer import TrainStep
from soccernerfs_tpu_torch.fields import nerfplayer_nerfacto as tf
from soccernerfs_tpu_torch.models import get_model
from soccernerfs_tpu_torch.models import nerfplayer_nerfacto as tn
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
    num_levels=3, log2_hashmap_size=13, temporal_dim=8, hidden_dim=16,
    hidden_dim_color=16, num_proposal_samples_per_ray=(12, 8),
    num_nerf_samples_per_ray=6,
    proposal_net_args_list=(
        {"hidden_dim": 8, "temporal_dim": 6, "log2_hashmap_size": 12,
         "num_levels": 3, "max_res": 32},
        {"hidden_dim": 8, "temporal_dim": 6, "log2_hashmap_size": 12,
         "num_levels": 3, "max_res": 64},
    ),
    disable_scene_contraction=True,
    eval_num_rays_per_chunk=64,
)
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


def _jax_draws(cfg, key, key_loss, n):
    """The JAX step's draws: get_outputs splits its key into (sampling,
    background), the sampling key into one key per level (a single
    jitter each), the background is uniform [N, 3]; get_loss_dict splits
    its key into one per grid of the temporal TV (the field, then the
    proposals by index) and draws an index_list row from each."""
    rng_sample, rng_bg = jax.random.split(key)
    keys = jax.random.split(rng_sample, cfg.num_proposal_iterations + 1)
    assert cfg.use_single_jitter
    jitters = [_t(jax.random.uniform(k, (n, 1))) for k in keys]
    background = _t(jax.random.uniform(rng_bg, (n, 3)))
    unique = dict(cfg.density_field_configs())
    grids = [cfg.field_config().grid] + [unique[i].grid for i in sorted(unique)]
    tv_keys = jax.random.split(key_loss, len(grids))
    rows = [int(jax.random.randint(k, (), 0, jh.temporal_tables(g)[3].shape[0]))
            for k, g in zip(tv_keys, grids)]
    return jitters, background, rows


def _jax_samples(rs):
    """The port's RaySamples as the JAX package's."""
    return jrays.RaySamples(**{
        f.name: (getattr(rs, f.name) if f.name == "spacing"
                 else None if getattr(rs, f.name) is None
                 else jnp.asarray(getattr(rs, f.name).detach().numpy()))
        for f in dataclasses.fields(rs)})


def _walk(tree, fn, path=()):
    if isinstance(tree, dict):
        return {k: _walk(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_walk(v, fn, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = jn.Config(**SMALL), tn.Config(**SMALL)

    def lift(path, x):
        # the init's tables are U(-1e-4, 1e-4): scale them to +-0.3 so the
        # encoding, not the MLP biases alone, shapes densities and gradients
        x = np.asarray(x)
        return x * 3000.0 if path[-1] == "embeddings" else x

    np_tree = _walk(jax.tree_util.tree_map(
        np.asarray, jn.init(jax.random.PRNGKey(0), jcfg, N_CAMS)), lift)
    jcams = jcam.Cameras.create(**_camera_args())
    aabb = jnp.asarray(AABB)

    def make_jax_step(jcfg):
        @functools.partial(jax.jit, static_argnums=(4,))
        def jax_step(params, batch, key, key_loss, flag, step):
            """The loss_fn of the JAX Trainer's shard_loss_and_grads (camera
            optimizer off), with the step's schedules (anneal traced, the
            proposal flag static)."""

            def loss_fn(p):
                rays = jcam.generate_rays(jcams, batch["cam_idx"], batch["coords"])
                outputs = jn.get_outputs(
                    jcfg, p, aabb, rays, rng=key, train=True,
                    anneal=jn._kp.proposal_anneal(jcfg, step),
                    train_proposal_networks=flag)
                metrics = jn.get_metrics_dict(jcfg, outputs, batch, step)
                loss_dict = jn.get_loss_dict(jcfg, p, outputs, batch, metrics,
                                             train=True, rng=key_loss)
                return functools.reduce(jnp.add, loss_dict.values()), (
                    loss_dict, metrics)

            return jax.value_and_grad(loss_fn, has_aux=True)(params)

        return jax_step

    return dict(jcfg=jcfg, tcfg=tcfg, np_tree=np_tree,
                jax_step=make_jax_step(jcfg), make_jax_step=make_jax_step,
                jcams=jcams)


def _trainer(tcfg):
    cams = tcam.Cameras.create(**_camera_args(), device=CPU)
    return TrainStep(tcfg, cams, AABB,
                     tmc.optimizer_configs["nerfplayer-nerfacto"], device=CPU,
                     model="nerfplayer_nerfacto")


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flag", [True, False])
def test_train_step_matches_jax(setup, flag):
    """One train step at step 300 (anneal 0.845), proposal update on and
    off: the loss, each loss term (rgb, interlevel, distortion, temporal
    TV over the three grids), PSNR and the distortion metric, and the
    gradient of every parameter (the three temporal tables, the MLPs, the
    appearance embedding) before the update, against jax.value_and_grad of
    the JAX step with the same params, batch and draws.

    Tolerances, as the nerfacto step's: the loss terms 1e-4 relative (f32
    sums in another order, bf16 MLP operands that round the other way on a
    rounding boundary, the PDF resampling's magnification of CDF
    rounding); the gradients, per tensor, 2e-2 of its max |grad| (a flipped
    bf16 rounding of an MLP operand is a 2^-8 step).  On non-update steps
    JAX returns zeros for the proposal MLPs; the port returns no gradient
    (None), which the optimizer takes as zeros.  The proposal tables get
    the temporal TV's gradient on every step."""
    jcfg, tcfg = setup["jcfg"], setup["tcfg"]
    step = 300
    batch = _batch()
    key, key_loss = jax.random.PRNGKey(11), jax.random.PRNGKey(12)
    (jloss, (jld, jmet)), jgrads = setup["jax_step"](
        jax.tree_util.tree_map(jnp.asarray, setup["np_tree"]),
        {k: jnp.asarray(v) for k, v in batch.items()}, key, key_loss, flag,
        step)

    trainer = _trainer(tcfg)
    state = trainer.init_state(convert.params_from_jax(setup["np_tree"],
                                                       device=CPU))
    state.step = step
    jitters, background, rows = _jax_draws(tcfg, key, key_loss, N_RAYS)
    loss, ld, met, grads = trainer.loss_and_grads(
        state, {k: _t(v) for k, v in batch.items()},
        train_proposal_networks=flag, jitters=jitters, background=background,
        tv_rows=rows)

    assert list(ld) == ["rgb_loss", "interlevel_loss", "distortion_loss",
                        "temporal_tv_loss"]
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
            assert name[2] == "mlp", name
            assert np.abs(np.asarray(jg)).max() == 0.0, name
            continue
        assert tuple(g.shape) == jg.shape, name
        assert np.abs(np.asarray(jg)).max() > 0.0, name
        assert _rel(g, jg) <= 2e-2, (name, _rel(g, jg))
        checked += 1
    # on non-update steps the two proposal MLPs (2 x 2 leaves each) get none
    assert checked == (len(jflat) if flag else len(jflat) - 8)


@pytest.mark.parametrize("kind", ["ds_nerf", "urf"])
def test_train_step_with_depth_matches_jax(setup, kind):
    """One train step at step 300, proposal update on, on a batch with
    target depths in [2, 4] (~10 % of them 0, no target): the depth loss
    over the three levels' weights (z-depths, ``depth_weight`` 0.05 as
    registered) beside every other term, the metrics, and every gradient
    before the update, against jax.value_and_grad of the JAX step with the
    same params, batch and draws.  Loss terms within 1e-4 relative;
    gradients within 1e-2 per leaf in L2 (the DS-NeRF term's 1 / (w + eps)
    weighs the rays' emptiest samples, whose bf16-rounded MLP inputs move
    single elements, so leaves are held in L2)."""
    jcfg = dataclasses.replace(setup["jcfg"], depth_loss_type=kind)
    tcfg = dataclasses.replace(setup["tcfg"], depth_loss_type=kind)
    step = 300
    batch = _batch()
    rng = np.random.default_rng(9)
    batch["depth_image"] = rng.uniform(2, 4, N_RAYS).astype(np.float32)
    batch["depth_image"][rng.uniform(0, 1, N_RAYS) < 0.1] = 0.0
    key, key_loss = jax.random.PRNGKey(11), jax.random.PRNGKey(12)
    (jloss, (jld, jmet)), jgrads = setup["make_jax_step"](jcfg)(
        jax.tree_util.tree_map(jnp.asarray, setup["np_tree"]),
        {k: jnp.asarray(v) for k, v in batch.items()}, key, key_loss, True,
        step)
    trainer = _trainer(tcfg)
    state = trainer.init_state(convert.params_from_jax(setup["np_tree"],
                                                       device=CPU))
    state.step = step
    jitters, background, rows = _jax_draws(tcfg, key, key_loss, N_RAYS)
    loss, ld, met, grads = trainer.loss_and_grads(
        state, {k: _t(v) for k, v in batch.items()},
        train_proposal_networks=True, jitters=jitters, background=background,
        tv_rows=rows)
    assert list(ld) == ["rgb_loss", "interlevel_loss", "distortion_loss",
                        "depth_loss", "temporal_tv_loss"]
    assert set(jld) == set(ld) and set(jmet) == set(met)
    assert float(ld["depth_loss"]) > 0.0
    assert _rel(loss, jloss) <= 1e-4
    for k in jld:
        assert _rel(ld[k], jld[k]) <= 1e-4, k
    for k in jmet:
        assert _rel(met[k], jmet[k]) <= 1e-4, k
    names = []
    _walk(state.params, lambda path, x: names.append(path))
    tgrads = dict(zip(names, grads))
    for path, jg in jax.tree_util.tree_flatten_with_path(jgrads)[0]:
        name = tuple(p.key if hasattr(p, "key") else p.idx for p in path)
        g, jg = tgrads[name].numpy(), np.asarray(jg)
        assert np.linalg.norm(g - jg) <= 1e-2 * np.linalg.norm(jg), name


def test_scatter_runs_every_step_and_proposals_only_on_update_steps(
        setup, monkeypatch):
    """A short loop through train_iteration from step 0 (every step updates
    the proposals) and from step 10,000 (an update every sixth step): the
    table gradient (scatter_add_rows' plain version here, width 1 over the
    flattened table) runs once for the main field on every step and once
    more per proposal field on the update steps; the proposal tables move
    on every step after the first (the temporal TV's gradient; the
    warm-up's first update has an lr of 0)."""
    calls = []
    plain = sk.scatter_add_rows_plain

    def counted(g, idxs, ws=None, *, rows):
        calls.append((rows, g.shape[1] // idxs.shape[0]))
        return plain(g, idxs, ws, rows=rows)

    monkeypatch.setattr(sk, "scatter_add_rows_plain", counted)
    tcfg = setup["tcfg"]
    trainer = _trainer(tcfg)
    state = trainer.init_state(convert.params_from_jax(setup["np_tree"],
                                                       device=CPU))
    assert set(state.params) == {"fields", "proposal_networks"}
    assert state.opt_state["fields"].mu[0].dtype == torch.float32
    batch = {k: _t(v) for k, v in _batch(1).items()}
    gen = torch.Generator().manual_seed(0)
    main = state.params["fields"]["grid"]["embeddings"]
    prop_table = state.params["proposal_networks"]["proposal_0"]["grid"]["embeddings"]
    for start, n in ((0, 3), (10_000, 8)):
        state.step, state.steps_since_update = start, 0
        host = {}
        for i in range(n):
            del calls[:]
            before = prop_table.detach().clone()
            metrics = trainer.train_iteration(state, batch, gen)
            updated = tn.host_static_kwargs(tcfg, start + i, host)[
                "train_proposal_networks"]
            assert len(calls) == (3 if updated else 1)
            assert calls.count((main.numel(), 1)) == 1
            assert all(c == 1 for _rows, c in calls)
            assert np.isfinite(float(metrics["Train Loss"]))
            # the warm-up's first update moves nothing (lr multiplier 0)
            assert torch.equal(before, prop_table.detach()) == (start + i == 0)
        assert state.step == start + n


def test_training_lowers_the_loss(setup):
    """Forty steps past the learning-rate warm-up on one batch whose target
    is one colour: the rgb loss falls below half its start, and the
    parameters stay finite."""
    trainer = _trainer(setup["tcfg"])
    state = trainer.init_state(convert.params_from_jax(setup["np_tree"],
                                                       device=CPU))
    state.step = 600
    for group in state.opt_state.values():
        group.count = 600             # past the schedule's 512-step warm-up
    batch = {k: _t(v) for k, v in _batch(2).items()}
    batch["image"][:] = torch.tensor([0.9, 0.1, 0.5])
    gen = torch.Generator().manual_seed(1)
    losses = [float(trainer.train_iteration(state, batch, gen)["rgb_loss"])
              for _ in range(40)]
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) / 2
    assert all(bool(torch.isfinite(p).all()) for p in tree_leaves(state.params))


def test_draws_and_refusals(setup):
    """train_draws gives a single jitter per level, a [N, 3] background and
    one index_list row per grid; a train forward that gets jitters without
    the random background, a loss without the TV rows and a field with
    position or time gradients are refused; a batch with target depths
    gets JAX's depth loss."""
    tcfg = setup["tcfg"]
    draws = tn.train_draws(tcfg, 5, torch.Generator().manual_seed(0), CPU)
    assert [tuple(j.shape) for j in draws["jitters"]] == [(5, 1)] * 3
    assert draws["background"].shape == (5, 3)
    assert len(draws["tv_rows"]) == 3
    for row, grid in zip(draws["tv_rows"], tn.tv_grids(tcfg)):
        assert 0 <= int(row) < grid.temporal_dim - 1
    params = convert.params_from_jax(setup["np_tree"], device=CPU)
    cams = tcam.Cameras.create(**_camera_args(), device=CPU)
    rays = tcam.generate_rays(cams, torch.zeros(4, dtype=torch.int32),
                              torch.full((4, 2), 4.0))
    draws = tn.train_draws(tcfg, 4, torch.Generator().manual_seed(0), CPU)
    with pytest.raises(ValueError, match="jitters and background"):
        tn.get_outputs(tcfg, params, _t(AABB), rays, train=True,
                       jitters=draws["jitters"])
    with torch.no_grad():
        out = tn.get_outputs(tcfg, params, _t(AABB), rays, train=True,
                             jitters=draws["jitters"],
                             background=draws["background"])
    metrics = tn.get_metrics_dict(tcfg, out, {"image": torch.zeros(4, 3)})
    with pytest.raises(ValueError, match="index_list rows"):
        tn.get_loss_dict(tcfg, params, out, {"image": torch.zeros(4, 3)}, metrics)
    # a batch with target depths: the DS-NeRF loss over the three levels
    # (z-depths as registered: times the directions' norms), JAX's function
    # on the same weights and samples
    depth = torch.tensor([1.0, 0.0, 2.5, 3.0])
    met = tn.get_metrics_dict(tcfg, out, {"image": torch.zeros(4, 3),
                                          "depth_image": depth}, step=300)
    want = sum(
        jL.depth_loss(jnp.asarray(w.numpy()), _jax_samples(rs),
                      jnp.asarray(depth.numpy()), jnp.asarray(out["depth"].numpy()),
                      jn._kp.depth_sigma_for_step(setup["jcfg"], 300),
                      jnp.asarray(out["directions_norm"].numpy()),
                      tcfg.is_euclidean_depth, tcfg.depth_loss_type)
        for w, rs in zip(out["weights_list"], out["ray_samples_list"])) / 3
    assert float(met["depth_loss"]) > 0.0
    assert _rel(met["depth_loss"], want) <= 1e-5
    with pytest.raises(NotImplementedError):
        tn.Config(detached_inputs=False).field_config()
    with pytest.raises(NotImplementedError):
        tf.TemporalHashMLPDensityFieldConfig(detached_inputs=False)
    with pytest.raises(KeyError):
        get_model("no_such_model")
    assert get_model("nerfplayer_nerfacto") is tn


# ---------------------------------------------------------------------------
# eval
# ---------------------------------------------------------------------------

def test_eval_chunk_and_render_camera_match_jax(setup):
    """get_outputs(train=False) on one camera's 64 pixels (time 0.5)
    against the JAX package (mean appearance embedding, no jitter, the
    random background handed to both sides as JAX draws it outside
    training, from PRNGKey(0)): rgb and accumulation to 1e-4 absolute (f32
    sums, bf16 MLP operands), median depth to 1e-4 relative on at least 62
    of 64 rays (it jumps where the cumulative weight sits at 0.5).
    render_camera's image equals one chunk of all its pixels with the
    port's own fixed-seed background; chunked, its depth and accumulation
    do too (the background is drawn per chunk)."""
    jcfg, tcfg = setup["jcfg"], setup["tcfg"]
    jcams = setup["jcams"]
    coords = np.stack(np.meshgrid(np.arange(H), np.arange(W), indexing="ij"),
                      -1).reshape(-1, 2).astype(np.float32) + 0.5
    idx = np.full(H * W, 1, np.int32)
    jrays = jcam.generate_rays(jcams, jnp.asarray(idx), jnp.asarray(coords))
    jout = jax.jit(lambda p: jn.get_outputs(
        jcfg, p, jnp.asarray(AABB), jrays, rng=None, train=False))(
        jax.tree_util.tree_map(jnp.asarray, setup["np_tree"]))
    background = _t(jax.random.uniform(jax.random.PRNGKey(0), (H * W, 3)))
    params = convert.params_from_jax(setup["np_tree"], device=CPU)
    cams = tcam.Cameras.create(**_camera_args(), device=CPU)
    rays = tcam.generate_rays(cams, _t(idx), _t(coords))
    with torch.no_grad():
        tout = tn.get_outputs(tcfg, params, _t(AABB), rays,
                              background=background)
    assert float(np.asarray(jout["accumulation"]).min()) < 0.99
    for k in ("rgb", "accumulation"):
        assert float(np.abs(_np(tout[k]) - np.asarray(jout[k])).max()) <= 1e-4, k
    for k in ("depth", "prop_depth_0", "prop_depth_1"):
        off = np.abs(_np(tout[k]) - np.asarray(jout[k])) / np.asarray(jout[k])
        assert (off <= 1e-4).sum() >= 62, k
    with torch.no_grad():
        own = tn.get_outputs(tcfg, params, _t(AABB), rays)
    for chunk, keys in ((64, ("rgb", "accumulation", "depth")),
                        (24, ("accumulation", "depth"))):
        image = render_camera(tcfg, params, cams, 1, chunk=chunk, device=CPU,
                              aabb=AABB, model="nerfplayer_nerfacto")
        assert image["rgb"].shape == (H, W, 3) and image["depth"].shape == (H, W)
        for k in keys:
            torch.testing.assert_close(image[k].reshape(H * W, -1),
                                       own[k].reshape(H * W, -1), rtol=1e-5,
                                       atol=1e-6)


# ---------------------------------------------------------------------------
# fields
# ---------------------------------------------------------------------------

def test_densities_match_jax(setup):
    """nerfplayer_nerfacto_density (density and geo features) and both
    temporal proposal fields' densities at points inside the scene box at
    times in [0, 1], 0 and 1 included: 1e-4 of the max (bf16 MLP operands
    on a rounding boundary; the encodings themselves agree to 1e-6)."""
    jcfg, tcfg = setup["jcfg"], setup["tcfg"]
    rng = np.random.default_rng(30)
    pos = rng.uniform(-1.45, 1.45, (500, 3)).astype(np.float32)
    times = rng.uniform(0, 1, 500).astype(np.float32)
    times[:2] = [0.0, 1.0]
    jp = jax.tree_util.tree_map(jnp.asarray, setup["np_tree"])
    tp = convert.params_from_jax(setup["np_tree"], device=CPU)
    jd, jgeo = jf.nerfplayer_nerfacto_density(
        jcfg.field_config(), jp["fields"], jnp.asarray(AABB), jnp.asarray(pos),
        jnp.asarray(times))
    td, tgeo = tf.nerfplayer_nerfacto_density(
        tcfg.field_config(), tp["fields"], _t(AABB), _t(pos), _t(times))
    assert _rel(td, jd) <= 1e-4 and _rel(tgeo, jgeo) <= 1e-4
    assert tgeo.shape == (500, 15)
    for (ji, jd_cfg), (ti, td_cfg) in zip(jcfg.density_field_configs(),
                                          tcfg.density_field_configs()):
        assert ji == ti and dataclasses.asdict(jd_cfg) == dataclasses.asdict(td_cfg)
        assert td_cfg.grid == tf.TemporalHashMLPDensityFieldConfig(
            **dataclasses.asdict(td_cfg)).grid
        want = jf.temporal_density_field_density(
            jd_cfg, jp["proposal_networks"][f"proposal_{ji}"], jnp.asarray(AABB),
            jnp.asarray(pos), jnp.asarray(times))
        got = tf.temporal_density_field_density(
            td_cfg, tp["proposal_networks"][f"proposal_{ti}"], _t(AABB), _t(pos),
            _t(times))
        assert _rel(got, want) <= 1e-4
    assert dataclasses.asdict(jcfg.field_config()) == dataclasses.asdict(
        tcfg.field_config())


@pytest.mark.parametrize("mode", ["train", "eval mean", "eval zeros",
                                  "view-independent"])
def test_rgb_matches_jax(setup, mode):
    """The colour head: SH degree 4 of the directions (none when
    view-independent), geo features and the appearance embedding (the
    camera's row in training; the mean row or zeros outside it): 1e-4
    absolute on sigmoid outputs."""
    rng = np.random.default_rng(31)
    geo = rng.standard_normal((300, 15)).astype(np.float32)
    dirs = rng.standard_normal((300, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    cams = rng.integers(0, N_CAMS, 300).astype(np.int32)
    change = {"use_average_appearance_embedding": mode == "eval mean",
              "disable_viewing_dependent": mode == "view-independent"}
    jfc = dataclasses.replace(setup["jcfg"].field_config(N_CAMS), **change)
    tfc = dataclasses.replace(setup["tcfg"].field_config(N_CAMS), **change)
    if mode == "view-independent":
        jp = jf.init_nerfplayer_nerfacto_field(jax.random.PRNGKey(5), jfc)
        jp = jax.tree_util.tree_map(np.asarray, jp)
    else:
        jp = setup["np_tree"]["fields"]
    tp = convert.params_from_jax(jp, device=CPU)
    jp = jax.tree_util.tree_map(jnp.asarray, jp)
    train = mode in ("train", "view-independent")
    want = jf.nerfplayer_nerfacto_rgb(jfc, jp, jnp.asarray(geo), jnp.asarray(dirs),
                                      jnp.asarray(cams) if train else None, train)
    got = tf.nerfplayer_nerfacto_rgb(tfc, tp, _t(geo), _t(dirs),
                                     _t(cams) if train else None, train)
    assert got.shape == (300, 3)
    assert float(np.abs(_np(got) - np.asarray(want)).max()) <= 1e-4


# ---------------------------------------------------------------------------
# the optimizer, the configs, the conversion
# ---------------------------------------------------------------------------

def test_adam_update_matches_optax():
    """Six updates of the registry's nerfplayer-nerfacto group optimizer
    (Adam, f32 moments, eps 1e-12, cosine decay with a 512-step warm-up)
    from update 509, across the end of the warm-up, fed the same gradients
    as the JAX chain: params and both moments to 1e-6 relative."""
    gcfg = tmc.optimizer_configs["nerfplayer-nerfacto"]["fields"]
    jgcfg = method_configs["nerfplayer-nerfacto"].optimizers["fields"]
    rng = np.random.default_rng(53)
    params = [rng.uniform(-1e-4, 1e-4, (40, 10)).astype(np.float32),
              rng.standard_normal((7,)).astype(np.float32)]
    jtx = jopt.build_group_optimizer(jgcfg["optimizer"], jgcfg["scheduler"])
    jp = [jnp.asarray(p) for p in params]
    jstate = jtx.init(jp)
    tp = [_t(p) for p in params]
    opt = gcfg["optimizer"]
    tstate = topt.adam_init(opt, tp)
    sched = topt.schedule_fn(gcfg["scheduler"], opt.lr)
    # start both counts at 509
    jstate = jax.tree_util.tree_map(
        lambda x: jnp.asarray(509, x.dtype)
        if getattr(x, "shape", None) == () and jnp.issubdtype(x.dtype, jnp.integer)
        else x, jstate)
    tstate.count = 509
    for i in range(6):
        grads = [rng.standard_normal(p.shape).astype(np.float32) * 10.0 ** -i
                 for p in params]
        grads[0][::2] = 0.0
        upd, jstate = jtx.update([jnp.asarray(g) for g in grads], jstate, jp)
        jp = optax.apply_updates(jp, upd)
        topt.adam_update(opt, sched, tstate, tp, [_t(g) for g in grads])
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-6, atol=1e-9)
    adam = [s for s in jstate if hasattr(s, "mu")][0]
    for mine, theirs in ((tstate.mu, adam.mu), (tstate.nu, adam.nu)):
        for a, b in zip(mine, theirs):
            assert a.dtype == torch.float32
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-12)


def test_train_configs_copy_registered_nerfplayer_nerfacto():
    """The port's nerfplayer-nerfacto model config, optimizers, schedules,
    camera optimizer (off) and rays per batch equal the JAX registry's; at
    registry width the main grid is 16 levels of 66 channels over
    5,710,032 rows (levels 0-5 dense), the proposal grids 5 levels of 34
    over 280,616 and 430,080 rows."""
    ref = method_configs["nerfplayer-nerfacto"]
    cfg = tmc.model_configs["nerfplayer-nerfacto"]
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref.pipeline.model)
    assert tmc.model_names["nerfplayer-nerfacto"] == ref.pipeline.model_name
    got = tmc.optimizer_configs["nerfplayer-nerfacto"]
    assert list(got) == list(ref.optimizers)
    for group, gcfg in ref.optimizers.items():
        mine = dataclasses.asdict(got[group]["optimizer"])
        theirs = dataclasses.asdict(gcfg["optimizer"])
        assert mine == {k: theirs[k] for k in mine}
        assert {k: v for k, v in theirs.items() if k not in mine} == {
            "max_norm": None, "kind": "adam", "nu_moment_dtype": "float32"}
        assert dataclasses.asdict(got[group]["scheduler"]) == dataclasses.asdict(
            gcfg["scheduler"])
    assert (tmc.camera_optimizer_configs["nerfplayer-nerfacto"].mode
            == ref.pipeline.datamanager.camera_optimizer.mode == "off")
    assert (tmc.train_num_rays_per_batch["nerfplayer-nerfacto"]
            == ref.pipeline.datamanager.train_num_rays_per_batch)
    from soccernerfs_tpu_torch.ops.hash_grid import level_layout, strided_levels

    main = cfg.field_config().grid
    assert (main.row_channels, main.num_levels) == (66, 16)
    assert level_layout(main)[0][-1] == 5_710_032
    assert sum(strided_levels(main)) == 6
    assert [(d.grid.row_channels, level_layout(d.grid)[0][-1])
            for _i, d in cfg.density_field_configs()] == [(34, 280_616),
                                                          (34, 430_080)]


def test_params_round_trip_and_seeded_tree(setup):
    """params_from_jax keeps the JAX tree's structure and values;
    seeded_params builds the same structure and shapes without JAX, and so
    does the port's own init."""
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
    assert set(params["fields"]) == {"grid", "mlp_base_decode",
                                     "appearance_embedding", "mlp_head"}
    for tree in (convert.seeded_params(setup["tcfg"], 3, N_CAMS),
                 tn.init(setup["tcfg"], N_CAMS, torch.Generator().manual_seed(0))):
        got = {}
        _walk(tree, lambda path, x: got.__setitem__(path, tuple(x.shape)))
        assert got == shapes
    table = convert.seeded_params(setup["tcfg"], 3, N_CAMS, grid_std=0.5)[
        "fields"]["grid"]["embeddings"]
    assert table.shape[1] == 10 and 0.4 < float(np.abs(table).max()) <= 0.5
