"""The port's K-Planes training step (soccernerfs_tpu_torch) against the JAX
package on the CPU: the losses, trunc_exp's gradient, the schedules, the
Adam update, and one whole train step (loss and every parameter gradient,
before the update), at a tiny config: F = 32, scales (1, 2), proposal
samples (24, 16) + 16 field samples, 96 rays from three cameras at three
times.

Torch cannot reproduce JAX's PRNG streams, so the tests make JAX's own
draws (the step key's split into sampling and background keys, the
per-level keys, the stratified uniforms and the background) and hand them
to the port as explicit jitters and background.  Inputs are made with
numpy from a seed; every tolerance is stated with its reason.
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
from soccernerfs_tpu.core import math as jmath
from soccernerfs_tpu.core import rays as jrays
from soccernerfs_tpu.engine import optimizers as jopt
from soccernerfs_tpu.engine import schedulers as jsched
from soccernerfs_tpu.models import kplanes as jk
from soccernerfs_tpu.ops import losses as jL
from soccernerfs_tpu_torch import convert
from soccernerfs_tpu_torch.configs import method_configs as tmc
from soccernerfs_tpu_torch.core import cameras as tcam
from soccernerfs_tpu_torch.core import math as tmath
from soccernerfs_tpu_torch.core import rays as trays
from soccernerfs_tpu_torch.engine import optimizers as topt
from soccernerfs_tpu_torch.engine import schedulers as tsched
from soccernerfs_tpu_torch.engine.trainer import TrainStep
from soccernerfs_tpu_torch.models import kplanes as tk
from soccernerfs_tpu_torch.ops import losses as tL
from soccernerfs_tpu_torch.ops.kernels import plane_kernels as tpk
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
TINY = dict(
    spacetime_resolution=(8, 8, 8, 5),
    feature_dim=32,
    multiscale_res=(1, 2),
    proposal_net_args_list=(
        {"feature_dim": 8, "resolution": (8, 8, 8, 5)},
        {"feature_dim": 8, "resolution": (16, 16, 16, 5)},
    ),
    num_proposal_samples_per_ray=(24, 16),
    num_nerf_samples_per_ray=16,
    sigma_net_hidden_dim=32,
    rgb_net_hidden_dim=32,
    disable_viewing_dependent=True,
    loss_coefficients=dict(tmc._KPLANES_LOSS_COEF),
)
AABB = np.array([[-1.5] * 3, [1.5] * 3], np.float32)
H = W = 8
N_RAYS = 96
LOSS_ORDER = ["rgb_loss", "distortion_loss", "interlevel_loss", "space_tv_loss",
              "space_tv_proposal_loss", "sparse_transients_loss",
              "sparse_transients_proposal_loss", "time_smoothness_loss",
              "time_smoothness_proposal_loss"]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rel(got, want) -> float:
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


def _unflatten(tree, leaves):
    """A tree shaped like ``tree`` holding ``leaves`` (tree_leaves' order)."""
    it = iter(leaves)

    def walk(x):
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, list):
            return [walk(v) for v in x]
        return next(it)

    return walk(tree)


def _camera_args():
    c2w = np.tile(np.eye(3, 4, dtype=np.float32)[None], (3, 1, 1))
    c2w[:, :, 3] = [[0.2, -0.1, 3.0], [-0.3, 0.2, 2.8], [0.0, 0.1, 3.2]]
    return dict(camera_to_worlds=c2w, fx=7.0, fy=7.5, cx=4.1, cy=3.9,
                width=W, height=H, times=np.array([0.1, 0.5, 0.9], np.float32))


def _time_noise(tree, seed=3):
    """Time planes init to exactly 1; jitter them so that their gradients
    and the time losses are not degenerate."""
    rng = np.random.default_rng(seed)

    def walk(x):
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, list):
            return [walk(v) for v in x]
        x = np.asarray(x)
        if x.ndim == 3 and np.all(x == 1.0):
            return (x + rng.uniform(-0.2, 0.2, x.shape)).astype(np.float32)
        return x

    return walk(tree)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "cam_idx": rng.integers(0, 3, N_RAYS).astype(np.int32),
        "coords": rng.uniform(0, H, (N_RAYS, 2)).astype(np.float32),
        "image": rng.uniform(0, 1, (N_RAYS, 3)).astype(np.float32),
    }


def _jax_draws(cfg, key, n):
    """get_outputs' draws from its key: split into (sampling, background),
    the sampling key into one key per level, one stratified uniform per
    level ([N, S + 1]), the [N, 3] background."""
    rng_sample, rng_bg = jax.random.split(key)
    keys = jax.random.split(rng_sample, cfg.num_proposal_iterations + 1)
    counts = [*cfg.num_proposal_samples_per_ray, cfg.num_nerf_samples_per_ray]
    jitters = [_t(jax.random.uniform(k, (n, s + 1))) for k, s in zip(keys, counts)]
    return jitters, _t(jax.random.uniform(rng_bg, (n, 3)))


@pytest.fixture(scope="module")
def setup():
    jcfg = jk.Config(**{**TINY, "loss_coefficients": tmc._KPLANES_LOSS_COEF})
    tcfg = tk.Config(**TINY)
    np_tree = _time_noise(jax.tree_util.tree_map(
        np.asarray, jax.jit(jk.init, static_argnums=1)(jax.random.PRNGKey(0),
                                                       jcfg)))
    jcams = jcam.Cameras.create(**_camera_args())
    aabb = jnp.asarray(AABB)

    @functools.partial(jax.jit, static_argnums=(3,))
    def jax_step(params, batch, key, flag, step):
        """The loss_fn of the JAX Trainer's shard_loss_and_grads, with the
        step's schedules (anneal traced, the proposal flag static)."""

        def loss_fn(p):
            rays = jcam.generate_rays(jcams, batch["cam_idx"], batch["coords"])
            outputs = jk.get_outputs(
                jcfg, p, aabb, rays, rng=key, train=True,
                anneal=jk.proposal_anneal(jcfg, step),
                train_proposal_networks=flag)
            metrics = jk.get_metrics_dict(jcfg, outputs, batch, step)
            loss_dict = jk.get_loss_dict(jcfg, p, outputs, batch, metrics,
                                         train=True)
            return functools.reduce(jnp.add, loss_dict.values()), (loss_dict,
                                                                   metrics)

        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    return dict(jcfg=jcfg, tcfg=tcfg, np_tree=np_tree, jax_step=jax_step)


def _trainer(tcfg):
    cams = tcam.Cameras.create(**_camera_args(), device=CPU)
    return TrainStep(tcfg, cams, AABB, tmc.optimizer_configs["k-planes"],
                     device=CPU)


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flag", [True, False])
def test_train_step_matches_jax(setup, flag):
    """One train step at step 300 (anneal 0.845), proposal update on and
    off: the loss, each loss term and PSNR, and the gradient of every
    parameter, before the update, against jax.value_and_grad of the JAX
    step with the same params, batch and draws.

    Tolerances.  The loss terms: 1e-4 relative (f32 sums in another
    order, bf16 MLP operands that round the other way where a hidden
    activation sits on a rounding boundary, and the PDF resampling, which
    magnifies CDF rounding where one bin holds most of the weight; measured
    ~1e-6).  The gradients: per tensor, 2e-2 of its max |grad|: JAX's CPU
    path gathers the planes from a bf16 table, so its transpose adds bf16
    cotangents (a scratch run put that rounding at 1.3e-2 of max |grad| on
    one plane), while the port's backward adds in f32.  On non-update
    steps JAX returns zeros for the proposal sigma nets; the port returns
    no gradient (None), which the optimizer takes as zeros."""
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
    jitters, background = _jax_draws(tcfg, key, N_RAYS)
    loss, ld, met, grads = trainer.loss_and_grads(
        state, {k: _t(v) for k, v in batch.items()},
        train_proposal_networks=flag, jitters=jitters, background=background)

    # JAX's jitted dict comes back with sorted keys; the port keeps
    # get_loss_dict's insertion order, in which the total is summed
    assert list(ld) == LOSS_ORDER and set(jld) == set(ld)
    assert _rel(loss, jloss) <= 1e-4
    for k in jld:
        assert _rel(ld[k], jld[k]) <= 1e-4, k
    assert _rel(met["psnr"], jmet["psnr"]) <= 1e-4
    jleaves = jax.tree_util.tree_leaves(jgrads)
    tgrads = _unflatten(state.params, grads)
    assert len(tree_leaves(tgrads)) == len(jleaves)
    checked = 0
    for path, jg in jax.tree_util.tree_flatten_with_path(jgrads)[0]:
        g = tgrads
        for p in path:
            g = g[p.key if hasattr(p, "key") else p.idx]
        if g is None:
            assert not flag and "proposal_networks" in str(path)
            assert np.abs(np.asarray(jg)).max() == 0.0, path
            continue
        assert tuple(g.shape) == jg.shape, path
        assert _rel(g, jg) <= 2e-2, (path, _rel(g, jg))
        checked += 1
    # on non-update steps the two proposal sigma nets (2 x 2 layers) get none
    assert checked == (len(jleaves) if flag else len(jleaves) - 8)


def test_bwd_packed_runs_only_on_update_steps(setup, monkeypatch):
    """A short loop through train_iteration from step 0 (every step
    updates the proposals) and from step 10,000 (an update every sixth
    step): the proposal tables' backward (bilerp_bwd_packed's plain
    version here) runs exactly on the update steps, the main field's
    (bilerp_bwd_unpacked) on every step, and parameters move once the
    warm-up lr is above 0."""
    calls = {"packed": 0, "unpacked": 0}
    for name, key in (("bilerp_bwd_packed_plain", "packed"),
                      ("bilerp_bwd_unpacked_plain", "unpacked")):
        fn = getattr(tpk, name)

        def counted(*a, _fn=fn, _key=key, **kw):
            calls[_key] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(tpk, name, counted)
    trainer = _trainer(setup["tcfg"])
    state = trainer.init_state(convert.params_from_jax(setup["np_tree"],
                                                       device=CPU))
    batch = {k: _t(v) for k, v in _batch(1).items()}
    gen = torch.Generator().manual_seed(0)
    leaf = state.params["fields"]["sigma_net"]["w"][0]
    for start, n in ((0, 3), (10_000, 8)):
        state.step, state.steps_since_update = start, 0
        host = {}
        for i in range(n):
            before = dict(calls)
            w0 = leaf.detach().clone()
            metrics = trainer.train_iteration(state, batch, gen)
            updated = tk.host_static_kwargs(setup["tcfg"], start + i, host)[
                "train_proposal_networks"]
            # one launch per plane group (y axis, width): 2 scales x 3
            assert calls["unpacked"] - before["unpacked"] == 6
            # 2 proposal fields x 3 plane groups
            assert calls["packed"] - before["packed"] == (6 if updated else 0)
            assert np.isfinite(float(metrics["Train Loss"]))
            moved = not torch.equal(w0, leaf.detach())
            assert moved == (start + i > 0)        # schedule(0) = 0
        assert state.step == start + n


def _f32_mlp(params, x, activation="relu", output_activation=None):
    """mlp_apply without the bf16 rounding of operands."""
    acts = {"relu": torch.relu, "sigmoid": torch.sigmoid, None: lambda h: h,
            "none": lambda h: h}
    h, n = x.float(), len(params["w"])
    for i, (w, b) in enumerate(zip(params["w"], params["b"])):
        h = acts[output_activation if i == n - 1 else activation](h @ w + b)
    return h


def test_one_ulp_sensitivity_comes_from_the_bf16_mlp(setup, monkeypatch):
    """The step's gradients under a one-ulp change of every other ray
    direction component, with the PDF bins held fixed.  With f32 MLPs no
    element moves by 1e-5 of its leaf's max (f32 rounding only; measured
    6.4e-7); with the bf16 MLP policy elements move by more than 30 times
    as much (a flipped bf16 rounding is a 2^-8 step; measured 1.2e-4 here,
    more at full width, where a fine cell holds few points).  So the
    card-vs-CPU gradient differences of that kind come from the policy,
    not from the plane path."""
    from soccernerfs_tpu_torch.engine import trainer as ttrainer
    from soccernerfs_tpu_torch.fields import kplanes as tfk
    from soccernerfs_tpu_torch.ops import samplers as tsamplers

    tcfg = setup["tcfg"]
    trainer = _trainer(tcfg)
    state = trainer.init_state(convert.params_from_jax(setup["np_tree"],
                                                       device=CPU))
    state.step = 300
    batch = {k: _t(v) for k, v in _batch(3).items()}
    jitters, background = _jax_draws(tcfg, jax.random.PRNGKey(5), N_RAYS)
    pdf, gen_rays = tsamplers.pdf_samples, ttrainer.generate_rays

    def grads(nudge, bins):
        """The gradients; the step without the nudge records its PDF
        resamplings into ``bins``, the nudged one takes their bins."""
        replay = iter(list(bins))

        def pdf_fixed(*a, **k):
            out = pdf(*a, **k)
            if not nudge:
                bins.append(out)
                return out
            rec = next(replay)
            return out.replace(starts=rec.starts, ends=rec.ends,
                               spacing_starts=rec.spacing_starts,
                               spacing_ends=rec.spacing_ends)

        def rays_nudged(*a, **k):
            rays = gen_rays(*a, **k)
            d = rays.directions.clone()
            d.view(-1)[::2] = torch.nextafter(d.view(-1)[::2], torch.tensor(2.0))
            return rays.replace(directions=d)

        monkeypatch.setattr(tsamplers, "pdf_samples", pdf_fixed)
        monkeypatch.setattr(ttrainer, "generate_rays",
                            rays_nudged if nudge else gen_rays)
        return trainer.loss_and_grads(
            state, batch, train_proposal_networks=True, jitters=jitters,
            background=background)[3]

    worst = {}
    for policy in ("bf16", "f32"):
        if policy == "f32":
            monkeypatch.setattr(tfk, "mlp_apply", _f32_mlp)
        bins = []
        base = grads(False, bins)
        moved = grads(True, bins)
        worst[policy] = max(_rel(a, b) for a, b in zip(moved, base)
                            if b is not None)
    assert worst["f32"] < 1e-5 and worst["bf16"] > 30 * worst["f32"], worst


def test_mlp_restores_the_callers_tf32_setting(monkeypatch):
    """``mlp_apply`` turns TF32 off for each layer's product and for both
    products of its backward, which autograd runs after ``mlp_apply`` has
    returned, and leaves the caller's setting as it found it; values and
    gradients are those of plain f32 matmuls."""
    from soccernerfs_tpu_torch.ops import mlp

    seen = []
    matmul = torch.Tensor.__matmul__

    def spy(a, b):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return matmul(a, b)

    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        for caller in (True, False):
            torch.backends.cuda.matmul.allow_tf32 = caller
            params = mlp.init_mlp(5, 8, 1, 3, torch.Generator().manual_seed(0))
            leaves = [x.requires_grad_(True) for x in params["w"] + params["b"]]
            x = torch.randn(2, 7, 5, generator=torch.Generator().manual_seed(1),
                            requires_grad=True)
            with monkeypatch.context() as m:
                m.setattr(torch.Tensor, "__matmul__", spy)
                del seen[:]
                y = mlp.mlp_apply(params, x, output_activation="sigmoid")
                forward = len(seen)
                grads = torch.autograd.grad(y.square().sum(), [x, *leaves])
            assert forward == 2 and len(seen) == 2 + 4 and not any(seen)
            assert torch.backends.cuda.matmul.allow_tf32 is caller
            # the same function with autograd's own matmul
            h = x.reshape(-1, 5).to(torch.bfloat16).float()
            for i, (w, b) in enumerate(zip(params["w"], params["b"])):
                h = torch.matmul(h, w.to(torch.bfloat16).float()) + b
                h = torch.relu(h).to(torch.bfloat16).float() if i == 0 else torch.sigmoid(h)
            want = torch.autograd.grad(h.square().sum(), [x, *leaves])
            assert torch.equal(y.reshape(-1, 3), h)
            for g, w in zip(grads, want):
                torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-7)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def test_training_lowers_the_loss(setup):
    """Eighty steps past the warm-up (lr ~1e-2) on one batch whose target
    is one colour: the rgb loss falls below a third of its start (the
    random background of the rays the fog leaves open keeps it above 0),
    and the parameters stay finite."""
    trainer = _trainer(setup["tcfg"])
    state = trainer.init_state(convert.params_from_jax(setup["np_tree"],
                                                       device=CPU))
    state.step = 600
    batch = {k: _t(v) for k, v in _batch(2).items()}
    batch["image"][:] = torch.tensor([0.9, 0.1, 0.5])
    gen = torch.Generator().manual_seed(1)
    losses = [float(trainer.train_iteration(state, batch, gen)["rgb_loss"])
              for _ in range(80)]
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) / 3
    assert all(bool(torch.isfinite(p).all()) for p in tree_leaves(state.params))


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def _samples(rng, n, s, sort_key=0.0):
    """RaySamples of both packages over the same sorted s-space bins."""
    edges = np.sort(rng.uniform(0, 1, (n, s + 1)).astype(np.float32), axis=-1)
    edges[:, 0] = sort_key
    common = dict(origins=np.zeros((n, 3), np.float32),
                  directions=np.tile(np.array([[0, 0, 1]], np.float32), (n, 1)),
                  pixel_area=np.ones(n, np.float32), starts=edges[:, :-1],
                  ends=edges[:, 1:], spacing_starts=edges[:, :-1],
                  spacing_ends=edges[:, 1:], s_near=np.zeros(n, np.float32),
                  s_far=np.ones(n, np.float32))
    j = jrays.RaySamples(**{k: jnp.asarray(v) for k, v in common.items()})
    t = trays.RaySamples(**{k: _t(v) for k, v in common.items()})
    return j, t


def _gather_outer(t0_starts, t0_ends, t1_starts, t1_ends, y1):
    """JAX's outer() written as the reference's searchsorted + gather, the
    indices clipped as JAX's masks clip them: its gradient goes to the one
    gathered cumulative sum, where JAX's masked max splits it among equal
    ones."""
    cy1 = jnp.concatenate([jnp.zeros_like(y1[..., :1]), jnp.cumsum(y1, -1)], -1)
    ss = jax.vmap(lambda a, v: jnp.searchsorted(a, v, side="right"))
    lo = jnp.maximum(ss(t1_starts, t0_starts) - 1, 0)
    hi = jnp.maximum(ss(t1_ends, t0_ends), 1)
    return (jnp.take_along_axis(cy1, hi, -1) - jnp.take_along_axis(cy1, lo, -1))


@pytest.mark.parametrize("weights_kind", ["random", "sparse"])
def test_interlevel_and_distortion_losses_match_jax(weights_kind, monkeypatch):
    """interlevel_loss (outer by searchsorted + gather) and distortion_loss
    against JAX's masked reductions, values and gradients w.r.t. every
    level's weights, 1e-5 relative (f32 sums in another order).  The bins
    include the clipped-index edges: final intervals wholly before the
    first proposal bin or past the last.

    "sparse" zeroes half the proposal weights, so cumulative sums tie.
    The values still match JAX's; the gradients are held to JAX's outer()
    written as searchsorted + gather (the reference's construction, the
    port's): JAX's masked max splits a gradient among tied cumulative
    sums, moving it between zero weights.  A zero weight that reaches
    parameters at all is one behind an opaque stretch, whose transmittance
    is 0 and passes no gradient on."""
    rng = np.random.default_rng(50)
    n = 40
    levels = [_samples(rng, n, 24, 0.05), _samples(rng, n, 16, 0.02),
              _samples(rng, n, 12, 0.0)]
    weights = [rng.uniform(0, 1, (n, s)).astype(np.float32) / s
               for s in (24, 16, 12)]
    if weights_kind == "sparse":
        for w in weights[:2]:
            w[w < 0.5 / w.shape[1]] = 0.0

    def jlosses(ws):
        return (jL.interlevel_loss(ws, [lv[0] for lv in levels])
                + 7.0 * jL.distortion_loss(ws, [lv[0] for lv in levels]))

    jws = [jnp.asarray(w) for w in weights]
    jval = jax.jit(jlosses)(jws)
    if weights_kind == "sparse":
        monkeypatch.setattr(jL, "outer", _gather_outer)
    jgrads = jax.jit(jax.grad(jlosses))(jws)
    tws = [_t(w).requires_grad_(True) for w in weights]
    tval = (tL.interlevel_loss(tws, [lv[1] for lv in levels])
            + 7.0 * tL.distortion_loss(tws, [lv[1] for lv in levels]))
    tval.backward()
    assert _rel(tval, jval) <= 1e-5
    for tw, jg in zip(tws, jgrads):
        assert _rel(tw.grad, jg) <= 1e-5


def test_outer_edge_values_match_jax():
    """outer() itself, where the clipped indices decide the value: target
    intervals before, inside, across and past the histogram, exact ties."""
    t1 = np.array([[0.2, 0.3, 0.5, 0.7, 0.9]], np.float32)
    y1 = np.array([[0.1, 0.0, 0.4, 0.2]], np.float32)
    t0 = np.array([[0.0, 0.1, 0.2, 0.3, 0.6, 0.7, 0.95, 1.0]], np.float32)
    want = jL.outer(jnp.asarray(t0[:, :-1]), jnp.asarray(t0[:, 1:]),
                    jnp.asarray(t1[:, :-1]), jnp.asarray(t1[:, 1:]),
                    jnp.asarray(y1))
    got = tL.outer(_t(t0[:, :-1]), _t(t0[:, 1:]), _t(t1[:, :-1]), _t(t1[:, 1:]),
                   _t(y1))
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_plane_losses_match_jax():
    """space_tv_loss, time_smoothness_loss and sparse_transients_loss on
    4D and 3D scales, values and gradients, against JAX run op by op (a
    jitted XLA fusion may skip the bf16 rounding of the differences).
    Values 1e-6 relative (the same bf16 differences, f32 means); gradients
    1e-2 of the max: both
    frameworks add the cotangents of the bf16 differences in bf16, and
    where two adds meet they may round in another order."""
    rng = np.random.default_rng(51)
    shapes4 = [(9, 8), (7, 8), (5, 8), (7, 9), (5, 9), (5, 7)]
    grids = [[rng.uniform(0.1, 0.5, (h, w, 4)).astype(np.float32) for h, w in shapes4],
             [rng.uniform(0.5, 1.5, (h, w, 4)).astype(np.float32) for h, w in shapes4],
             [rng.uniform(0.1, 0.5, (6, 5, 4)).astype(np.float32) for _ in range(3)]]

    def jfn(gs):
        return (jL.space_tv_loss(gs) + 3.0 * jL.time_smoothness_loss(gs[:2])
                + 5.0 * jL.sparse_transients_loss(gs[:2]))

    jval, jgrads = jax.value_and_grad(jfn)(
        [[jnp.asarray(g) for g in s] for s in grids])
    tg = [[_t(g).requires_grad_(True) for g in s] for s in grids]
    tval = (tL.space_tv_loss(tg) + 3.0 * tL.time_smoothness_loss(tg[:2])
            + 5.0 * tL.sparse_transients_loss(tg[:2]))
    tval.backward()
    assert _rel(tval, jval) <= 1e-6
    for ts, js in zip(tg, jgrads):
        for t, j in zip(ts, js):
            assert _rel(t.grad, j) <= 1e-2
    np.testing.assert_allclose(
        _np(tL.mse_loss(_t(grids[0][0]), _t(grids[1][0]))),
        np.asarray(jL.mse_loss(jnp.asarray(grids[0][0]), jnp.asarray(grids[1][0]))),
        rtol=1e-6)


def test_trunc_exp_gradient_matches_jax():
    """trunc_exp: exp forward, exp(clamp(x, -15, 15)) backward, 1e-6."""
    x = np.array([-40.0, -15.5, -15.0, -3.0, 0.0, 2.5, 15.0, 15.5, 30.0],
                 np.float32)
    jval, jgrad = jax.vjp(jmath.trunc_exp, jnp.asarray(x))
    cot = np.linspace(0.5, 2.0, x.size).astype(np.float32)
    tx = _t(x).requires_grad_(True)
    tval = tmath.trunc_exp(tx)
    tval.backward(_t(cot))
    np.testing.assert_allclose(_np(tval), np.asarray(jval), rtol=1e-6)
    np.testing.assert_allclose(_np(tx.grad), np.asarray(jgrad(jnp.asarray(cot))[0]),
                               rtol=1e-6)
    assert np.isfinite(_np(tx.grad)).all()


# ---------------------------------------------------------------------------
# schedules and the optimizer
# ---------------------------------------------------------------------------

def test_proposal_schedules_match_jax(setup):
    """proposal_anneal (f32) exactly, and host_static_kwargs' decision and
    counter over steps 0-20 and 10,000-10,020, equal to the JAX package's."""
    jcfg, tcfg = setup["jcfg"], setup["tcfg"]
    for start in (0, 10_000):
        jhost, thost = {}, {}
        for step in range(start, start + 21):
            assert tk.proposal_anneal(tcfg, step) == float(
                jk.proposal_anneal(jcfg, jnp.asarray(step, jnp.int32)))
            assert (tk.host_static_kwargs(tcfg, step, thost)
                    == jk.host_static_kwargs(jcfg, step, jhost))
            assert thost == jhost
    assert tk.proposal_anneal(tcfg, 2000) == 1.0


@pytest.mark.parametrize("kind", ["cosine", "exponential"])
def test_schedules_match_jax(kind):
    """The lr multipliers over warm-up, decay and past the end, 1e-6."""
    if kind == "cosine":
        args = dict(warm_up_end=512, max_steps=30000, learning_rate_alpha=0.05)
        jf = jsched.cosine_decay_schedule(jsched.CosineDecaySchedulerConfig(**args))
        tf = tsched.cosine_decay_schedule(tsched.CosineDecaySchedulerConfig(**args))
    else:
        args = dict(lr_final=1e-4, max_steps=20000, warmup_steps=100)
        jf = jsched.exponential_decay_schedule(
            jsched.ExponentialDecaySchedulerConfig(**args), 1e-2)
        tf = tsched.exponential_decay_schedule(
            tsched.ExponentialDecaySchedulerConfig(**args), 1e-2)
    for step in (0, 1, 50, 99, 100, 511, 512, 513, 5000, 29999, 30000, 40000):
        np.testing.assert_allclose(float(tf(step)), float(jf(step)), rtol=1e-6,
                                   atol=1e-7)


def _assert_same_optimizer(mine, theirs):
    """The port's Adam config equals the JAX one on every field it has
    (lr, eps, weight decay, clipping, both moments' storage types), and the
    JAX one is Adam, not RAdam."""
    ref = dataclasses.asdict(theirs)
    got = dataclasses.asdict(mine)
    assert got == {k: ref[k] for k in got}
    assert type(theirs) is jopt.AdamOptimizerConfig
    # the port's Adam config has no ``kind`` (RAdam is a class of its own);
    # clipping and the second moment's storage type are compared above
    assert {k: v for k, v in ref.items() if k not in got} == {"kind": "adam"}
    assert (got["weight_decay"], got["moment_dtype"]) == (0.0, "bfloat16")


def test_adam_update_matches_scale_by_adam_lowp():
    """Four updates of the registry's k-planes group optimizer (eps 1e-12,
    bf16 first moment, cosine warm-up) fed the same gradients as the JAX
    chain scale_by_adam_lowp + scale_by_schedule(-lr * schedule): params
    and both moments to 1e-6 relative.  The first update moves nothing
    (schedule(0) = 0); a gradient of None is a zero gradient."""
    gcfg = tmc.optimizer_configs["k-planes"]["fields"]
    jgcfg = method_configs["k-planes"].optimizers["fields"]
    _assert_same_optimizer(gcfg["optimizer"], jgcfg["optimizer"])
    assert gcfg["scheduler"].__dict__ == jgcfg["scheduler"].__dict__
    rng = np.random.default_rng(52)
    params = [rng.uniform(0.1, 0.5, (6, 5, 4)).astype(np.float32),
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
        if i == 2:
            grads[1] = np.zeros_like(grads[1])
        upd, jstate = jtx.update([jnp.asarray(g) for g in grads], jstate, jp)
        jp = optax.apply_updates(jp, upd)
        topt.adam_update(opt, sched, tstate, tp,
                         [None if i == 2 and k == 1 else _t(g)
                          for k, g in enumerate(grads)])
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-6, atol=1e-7)
        if i == 0:
            for a, p in zip(tp, params):
                np.testing.assert_array_equal(_np(a), p)
    adam = jstate[0]
    for mine, theirs in ((tstate.mu, adam.mu), (tstate.nu, adam.nu)):
        for a, b in zip(mine, theirs):
            assert a.dtype == (torch.float32 if b.dtype == jnp.float32
                               else torch.bfloat16)
            np.testing.assert_allclose(a.float().numpy(),
                                       np.asarray(b.astype(jnp.float32)),
                                       rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("case", ["clip f32", "clip lowp", "nu bf16",
                                  "clip radam"])
def test_optimizer_options_match_optax(case):
    """``max_norm`` (optax's clip_by_global_norm over the group, before the
    weight decay) and ``nu_moment_dtype="bfloat16"`` (scale_by_adam_lowp's
    bf16 second moment beside a bf16 first one) against the JAX package's
    chain (build_group_optimizer) fed the same gradients: five updates
    whose gradients' global norm runs from above the clip to below it,
    one with a None (zero) leaf; params within 1e-6 relative (f32
    arithmetic, the same order); both moments' storage types, f32 moments
    within 1e-6 of their max and bf16 ones within one bf16 ulp per element
    (the global norm sums the squares in another order, so a clipped
    gradient may differ by an f32 ulp, and a bf16 rounding may flip on
    it).  The options reach the CLI's dotted overrides."""
    from soccernerfs_tpu_torch.configs.cli import parse_train_cli

    kw = {"clip f32": dict(max_norm=0.5, weight_decay=1e-2),
          "clip lowp": dict(max_norm=2.0, moment_dtype="bfloat16"),
          "nu bf16": dict(moment_dtype="bfloat16", nu_moment_dtype="bfloat16"),
          "clip radam": dict(max_norm=0.5)}[case]
    radam = case == "clip radam"
    jcfg = (jopt.RAdamOptimizerConfig if radam else jopt.AdamOptimizerConfig)(
        lr=1e-2, eps=1e-8, **kw)
    tcfg = (topt.RAdamOptimizerConfig if radam else topt.AdamOptimizerConfig)(
        lr=1e-2, eps=1e-8, **kw)
    rng = np.random.default_rng(53)
    params = [rng.uniform(0.1, 0.5, (6, 5, 4)).astype(np.float32),
              rng.standard_normal((7,)).astype(np.float32)]
    jtx = jopt.build_group_optimizer(jcfg, None)
    jp = [jnp.asarray(p) for p in params]
    jstate = jtx.init(jp)
    tp = [_t(p) for p in params]
    tstate = topt.adam_init(tcfg, tp)
    sched = topt.schedule_fn(None, tcfg.lr)
    for i in range(5):
        grads = [rng.standard_normal(p.shape).astype(np.float32) * 0.5 ** i
                 for p in params]
        if i == 2:
            grads[1] = np.zeros_like(grads[1])
        upd, jstate = jtx.update([jnp.asarray(g) for g in grads], jstate, jp)
        jp = optax.apply_updates(jp, upd)
        topt.group_update(tcfg, sched, tstate, tp,
                          [None if i == 2 and k == 1 else _t(g)
                           for k, g in enumerate(grads)])
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-6,
                                       atol=1e-7)
    moments = [st for st in jax.tree_util.tree_leaves(
        jstate, is_leaf=lambda x: hasattr(x, "mu")) if hasattr(st, "mu")][0]
    for mine, theirs in ((tstate.mu, moments.mu), (tstate.nu, moments.nu)):
        for a, b in zip(mine, theirs):
            assert a.dtype == (torch.float32 if b.dtype == jnp.float32
                               else torch.bfloat16)
            want = np.asarray(b.astype(jnp.float32))
            if a.dtype == torch.float32:
                assert _rel(a, want) <= 1e-6
            else:
                np.testing.assert_allclose(a.float().numpy(), want,
                                           rtol=2.0 ** -7, atol=0)
    if case == "nu bf16":
        assert all(n.dtype == torch.bfloat16 for n in tstate.nu)
    cfg = parse_train_cli([
        "k-planes", "--optimizers.fields.optimizer.max-norm", "1.5",
        "--optimizers.proposal-networks.optimizer.nu-moment-dtype", "bfloat16",
        "blender-data"])
    assert cfg.optimizers["fields"]["optimizer"].max_norm == 1.5
    assert (cfg.optimizers["proposal_networks"]["optimizer"].nu_moment_dtype
            == "bfloat16")
    assert tmc.optimizer_configs["k-planes"]["fields"]["optimizer"].max_norm is None


def test_train_configs_copy_registered_kplanes():
    """The port's k-planes optimizers, schedules and rays per batch equal
    the JAX registry's."""
    ref = method_configs["k-planes"]
    got = tmc.optimizer_configs["k-planes"]
    assert list(got) == list(ref.optimizers)
    for group, gcfg in ref.optimizers.items():
        _assert_same_optimizer(got[group]["optimizer"], gcfg["optimizer"])
        assert (dataclasses.asdict(got[group]["scheduler"])
                == dataclasses.asdict(gcfg["scheduler"])), group
    assert (tmc.train_num_rays_per_batch["k-planes"]
            == ref.pipeline.datamanager.train_num_rays_per_batch)
