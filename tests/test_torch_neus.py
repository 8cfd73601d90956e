"""The port's NeuS (soccernerfs_tpu_torch/models/neus.py, fields/sdf.py,
ops/neus_sampler.py) and what it stands on, against the JAX package on
the CPU: the weights from alphas and the normals' compositing; the fixed
inverse deviation's alphas; the NeuS sampler's merged bins with JAX's own
jitters; the SDF field, its normals against ``jax.grad``; one eval chunk;
one whole train step (the rgb and eikonal losses and every gradient
before the update, through the double backward) against
``jax.value_and_grad``; a render under ``no_grad``; the seeded params;
the registry copy.

Small sizes: an SDF MLP of 3 x 32, a colour MLP of 2 x 16, 16 uniform
samples and 4 upsampling steps of 4, near and far planes at 2 and 6 (the
registry's 0.05 and 1000 would put the bins 15 units apart), 64 rays of
three cameras on +z.  Inputs are made with numpy from a seed; torch cannot
reproduce JAX's PRNG streams, so the tests make JAX's own jitter draws and
hand them to the port.  Every tolerance is stated with its reason.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from soccernerfs_tpu.configs.method_configs import method_configs
from soccernerfs_tpu.core import camera_optimizer as jco
from soccernerfs_tpu.core import cameras as jcam
from soccernerfs_tpu.core import rays as jrays
from soccernerfs_tpu.fields import sdf as jsdf
from soccernerfs_tpu.models import neus as jneus
from soccernerfs_tpu.ops import neus_sampler as jns
from soccernerfs_tpu.ops import rendering as jrender
from soccernerfs_tpu.ops import samplers as jsamplers
from soccernerfs_tpu_torch import convert
from soccernerfs_tpu_torch.configs import method_configs as tmc
from soccernerfs_tpu_torch.core import camera_optimizer as tco
from soccernerfs_tpu_torch.core import cameras as tcam
from soccernerfs_tpu_torch.core import rays as trays
from soccernerfs_tpu_torch.engine.render import render_camera
from soccernerfs_tpu_torch.engine.trainer import TrainStep
from soccernerfs_tpu_torch.fields import sdf as tsdf
from soccernerfs_tpu_torch.models import neus as tneus
from soccernerfs_tpu_torch.models.vanilla_nerf import with_planes
from soccernerfs_tpu_torch.ops import neus_sampler as tns
from soccernerfs_tpu_torch.ops import rendering as trender
from soccernerfs_tpu_torch.ops import samplers as tsamplers


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch CPU thread while this file runs (the suite runs in
    parallel worker processes, whose default thread pools oversubscribe
    the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


CPU = "cpu"
AABB = np.array([[-1.5] * 3, [1.5] * 3], np.float32)
H = W = 8
N_RAYS = 64
N_CAMS = 3
SMALL_FIELD = dict(num_layers=3, hidden_dim=32, geo_feat_dim=16,
                   num_layers_color=2, hidden_dim_color=16)
SMALL = dict(num_samples=16, num_samples_importance=16, num_upsample_steps=4,
             near_plane=2.0, far_plane=6.0, eval_num_rays_per_chunk=32)


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


def _configs():
    jcfg = method_configs["neus"].pipeline.model
    jcfg = dataclasses.replace(jcfg, sdf_field=dataclasses.replace(
        jcfg.sdf_field, **SMALL_FIELD), **SMALL)
    tcfg = tmc.model_configs["neus"]
    tcfg = dataclasses.replace(tcfg, sdf_field=dataclasses.replace(
        tcfg.sdf_field, **SMALL_FIELD), **SMALL)
    return jcfg, tcfg


def _camera_args():
    """Three cameras on +z, 4 from the origin, looking down -z: their rays
    cross the initial sphere (radius 0.8 about the origin)."""
    c2w = np.tile(np.eye(3, 4, dtype=np.float32)[None], (N_CAMS, 1, 1))
    c2w[:, :, 3] = [[0.2, -0.1, 4.0], [-0.3, 0.2, 3.8], [0.0, 0.1, 4.2]]
    return dict(camera_to_worlds=c2w, fx=7.0, fy=7.5, cx=4.1, cy=3.9,
                width=W, height=H)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "cam_idx": rng.integers(0, N_CAMS, N_RAYS).astype(np.int32),
        "coords": rng.uniform(0, H, (N_RAYS, 2)).astype(np.float32),
        "image": rng.uniform(0, 1, (N_RAYS, 3)).astype(np.float32),
    }


def _jax_jitters(key, n, cfg):
    """The JAX forward's draws: get_outputs splits its key into (sampler,
    background); the sampler splits its own into one key per sampling,
    each a single jitter [N, 1]."""
    rng_s, _ = jax.random.split(key)
    keys = jax.random.split(rng_s, cfg.num_upsample_steps + 1)
    return [_t(jax.random.uniform(k, (n, 1))) for k in keys]


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = _configs()
    # the port's seed: the geometric init with the raw-position rows kept,
    # a sphere of radius 0.8 (test_seeded_params_have_the_jax_layout)
    np_tree = convert.seeded_params(tcfg, 0)
    jcams = jcam.Cameras.create(**_camera_args())
    aabb = jnp.asarray(AABB)

    @jax.jit
    def jax_step(params, batch, key):
        def loss_fn(p):
            rays = jcam.generate_rays(jcams, batch["cam_idx"], batch["coords"])
            outputs = jneus.get_outputs(jcfg, p, aabb, rays, rng=key, train=True)
            metrics = jneus.get_metrics_dict(jcfg, outputs, batch)
            loss_dict = jneus.get_loss_dict(jcfg, p, outputs, batch, metrics)
            return functools.reduce(jnp.add, loss_dict.values()), (
                loss_dict, metrics)

        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    @jax.jit
    def jax_eval(params, batch):
        rays = jcam.generate_rays(jcams, batch["cam_idx"], batch["coords"])
        return jneus.get_outputs(jcfg, params, aabb, rays, rng=None, train=False)

    @jax.jit
    def jax_sample(params, batch, key, shift):
        """The sampler's bins; with ``shift`` 1, every other component of
        the rays' directions one f32 ulp up."""
        rays = jcam.generate_rays(jcams, batch["cam_idx"], batch["coords"])
        d = rays.directions
        every_other = (jnp.arange(d.size) % 2 == 0).reshape(d.shape)
        rays = rays.replace(directions=jnp.where(
            every_other & (shift > 0), jnp.nextafter(d, 2.0), d))
        n = rays.origins.shape[0]
        rays = rays.replace(nears=jnp.full((n,), jcfg.near_plane),
                            fars=jnp.full((n,), jcfg.far_plane))
        rng_s, _ = jax.random.split(key)
        samples = jns.neus_sample(
            rays, lambda p: jsdf.sdf_value(jcfg.sdf_field, params["fields"], p),
            num_samples=jcfg.num_samples,
            num_samples_importance=jcfg.num_samples_importance,
            num_upsample_steps=jcfg.num_upsample_steps,
            base_variance=jcfg.base_variance, rng=rng_s, stratified=True)
        return samples.spacing_starts, samples.spacing_ends, samples.starts

    return dict(jcfg=jcfg, tcfg=tcfg, np_tree=np_tree, jax_step=jax_step,
                jax_eval=jax_eval, jax_sample=jax_sample)


def _port_rays(batch):
    cams = tcam.Cameras.create(**_camera_args(), device=CPU)
    return tcam.generate_rays(cams, _t(batch["cam_idx"]), _t(batch["coords"]))


# ---------------------------------------------------------------------------
# compositing and the sampler's pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("weights_only", [True, False])
def test_weights_from_alphas_match_jax(weights_only):
    """Exact up to f32 products in the same order: within 1e-6."""
    rng = np.random.default_rng(0)
    alphas = rng.uniform(0, 1, (32, 24)).astype(np.float32)
    alphas[:, ::5] = 0.0
    alphas[3] = 1.0
    want = jrays.get_weights_and_transmittance_from_alphas(
        jnp.asarray(alphas), weights_only=weights_only)
    got = trays.get_weights_and_transmittance_from_alphas(
        _t(alphas), weights_only=weights_only)
    if weights_only:
        want, got = (want,), (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert _rel(g, w) <= 1e-6
    # the 1e-7 inside the product: a ray of alphas 1 keeps a transmittance
    assert float(got[0][3, 1]) > 0.0


@pytest.mark.parametrize("normalize", [True, False])
def test_render_normals_match_jax(normalize):
    rng = np.random.default_rng(1)
    normals = rng.normal(size=(32, 12, 3)).astype(np.float32)
    weights = rng.uniform(0, 0.1, (32, 12)).astype(np.float32)
    want = jrender.render_normals(jnp.asarray(normals), jnp.asarray(weights),
                                  normalize=normalize)
    got = trender.render_normals(_t(normals), _t(weights), normalize=normalize)
    assert _rel(got, want) <= 1e-6
    if normalize:
        assert np.allclose(np.linalg.norm(_np(got), axis=-1), 1.0, atol=1e-5)


def _spaced(n, s, seed):
    """Uniform samples between 2 and 6 along random rays, on both sides."""
    rng = np.random.default_rng(seed)
    origins = rng.normal(size=(n, 3)).astype(np.float32)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    kw = dict(origins=origins, directions=dirs,
              pixel_area=np.ones(n, np.float32), nears=np.full(n, 2.0, np.float32),
              fars=np.full(n, 6.0, np.float32))
    jb = jrays.RayBundle(**{k: jnp.asarray(v) for k, v in kw.items()})
    tb = trays.RayBundle(**{k: _t(v) for k, v in kw.items()})
    jitter = rng.uniform(0, 1, (n, 1)).astype(np.float32)
    js = jsamplers.spaced_samples(jb, s, "uniform", None, False)
    ts = tsamplers.spaced_samples(tb, s, "uniform")
    return jb, tb, js, ts, jitter


def test_rendering_sdf_with_fixed_inv_s_matches_jax():
    """Within 1e-5 of the largest alpha: the same f32 arithmetic."""
    _, _, js, ts, _ = _spaced(48, 16, 2)
    rng = np.random.default_rng(3)
    sdf = (np.cumsum(rng.normal(0, 0.3, (48, 16)), axis=-1) - 0.5).astype(np.float32)
    for inv_s in (64.0, 512.0):
        want = jns.rendering_sdf_with_fixed_inv_s(js, jnp.asarray(sdf), inv_s)
        got = tns.rendering_sdf_with_fixed_inv_s(ts, _t(sdf), inv_s)
        assert got.shape == want.shape == (48, 15)
        assert _rel(got, want) <= 1e-5


def test_merge_ray_samples_sorts_as_jax():
    """The sorted union of two bin sets, ties included (the second set
    repeats some starts of the first): bins equal, euclidean starts within
    an ulp."""
    jb, tb, js, ts, _ = _spaced(16, 8, 4)
    starts = _np(ts.spacing_starts)
    other = np.sort(np.concatenate([starts[:, ::2], np.random.default_rng(5)
                                    .uniform(0, 1, (16, 4)).astype(np.float32)],
                                   -1), -1)
    ends = np.concatenate([other[:, 1:], np.ones((16, 1), np.float32)], -1)
    js2 = js.replace(spacing_starts=jnp.asarray(other),
                     spacing_ends=jnp.asarray(ends))
    ts2 = ts.replace(spacing_starts=_t(other), spacing_ends=_t(ends))
    want = jns._merge_ray_samples(jb, js, js2)
    got = tns.merge_ray_samples(tb, ts, ts2)
    assert np.array_equal(_np(got.spacing_starts), np.asarray(want.spacing_starts))
    assert np.array_equal(_np(got.spacing_ends), np.asarray(want.spacing_ends))
    assert _rel(got.starts, want.starts) <= 1e-6


def test_neus_sample_matches_jax(setup):
    """The whole sampler with JAX's jitters on the seeded SDF.  Each
    upsampling step turns rounding differences of the SDF into moves of
    the CDF, and a bin of little weight stretches them (ROADMAP C.6); the
    next steps compound them.  So the rays whose merged bins differ by
    more than 1e-5 relative are counted, not held elementwise, beside a
    witness: JAX's own sampler with every other direction component one
    f32 ulp up, which moves 2-5 of these 64 rays by up to ~1.7e-4.  The
    port may differ on at most twice the witness's rays (+1), each bin
    within 1e-3 relative; the rays that differ are printed."""
    tcfg = setup["tcfg"]
    batch = _batch(1)
    key = jax.random.PRNGKey(7)
    jparams = jax.tree_util.tree_map(jnp.asarray, setup["np_tree"])
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jstarts, jends, jeuclid = setup["jax_sample"](jparams, jbatch, key, 0)
    wstarts, wends, _ = setup["jax_sample"](jparams, jbatch, key, 1)
    params = convert.params_from_jax(setup["np_tree"], CPU)
    rays = with_planes(tcfg, _port_rays(batch))
    samples = tns.neus_sample(
        rays, lambda p: tsdf.sdf_value(tcfg.sdf_field, params["fields"], p),
        num_samples=tcfg.num_samples,
        num_samples_importance=tcfg.num_samples_importance,
        num_upsample_steps=tcfg.num_upsample_steps,
        base_variance=tcfg.base_variance,
        jitters=_jax_jitters(key, N_RAYS, tcfg))
    assert samples.spacing_starts.shape == jstarts.shape == (N_RAYS, 32)

    def bins(starts, ends):
        return np.concatenate([_np(starts), _np(ends)[:, -1:]], -1)

    want = bins(jstarts, jends)
    rel = np.abs(bins(samples.spacing_starts, samples.spacing_ends) - want
                 ) / np.maximum(np.abs(want), 1e-30)
    witness = np.abs(bins(wstarts, wends) - want) / np.maximum(np.abs(want), 1e-30)
    differ = np.nonzero((rel > 1e-5).any(-1))[0]
    n_witness = int((witness > 1e-5).any(-1).sum())
    print(f"rays whose merged bins differ by > 1e-5 relative: {len(differ)} "
          f"of {N_RAYS} (witness, JAX with directions + 1 ulp: {n_witness}, "
          f"worst {witness.max():.3e})")
    for i in differ:
        print(f"  ray {i}: worst relative difference {rel[i].max():.3e}")
    assert len(differ) <= 2 * n_witness + 1
    assert rel.max() <= 1e-3
    assert not samples.spacing_starts.requires_grad


# ---------------------------------------------------------------------------
# the SDF field
# ---------------------------------------------------------------------------

def _points(n=256, seed=6):
    return np.random.default_rng(seed).uniform(-1.2, 1.2, (n, 3)).astype(np.float32)


def test_sdf_field_matches_jax(setup):
    """sdf and features (f32 layers on both sides) within 1e-5 of their
    largest value; the colour head (bf16 operands) within 1e-3."""
    jcfg, tcfg = setup["jcfg"], setup["tcfg"]
    jp = jax.tree_util.tree_map(jnp.asarray, setup["np_tree"])["fields"]
    tp = convert.params_from_jax(setup["np_tree"], CPU)["fields"]
    x = _points()
    d = np.random.default_rng(7).normal(size=x.shape).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    js, jf = jsdf.sdf_and_features(jcfg.sdf_field, jp, jnp.asarray(x))
    ts, tf = tsdf.sdf_and_features(tcfg.sdf_field, tp, _t(x))
    assert _rel(ts, js) <= 1e-5 and _rel(tf, jf) <= 1e-5
    n = d  # unit vectors stand in for normals
    jr = jsdf.sdf_rgb(jcfg.sdf_field, jp, jnp.asarray(x), jnp.asarray(d),
                      jnp.asarray(n), jf)
    tr = tsdf.sdf_rgb(tcfg.sdf_field, tp, _t(x), _t(d), _t(n), tf)
    assert _rel(tr, jr) <= 1e-3
    assert float(tsdf.inv_s(tp)) == pytest.approx(float(jsdf.inv_s(jp)), rel=1e-6)


def test_sdf_normals_match_jax_grad(setup):
    """The SDF's gradient in the positions within 1e-5 of its largest
    component, under no_grad too (a render's mode)."""
    jcfg, tcfg = setup["jcfg"], setup["tcfg"]
    jp = jax.tree_util.tree_map(jnp.asarray, setup["np_tree"])["fields"]
    tp = convert.params_from_jax(setup["np_tree"], CPU)["fields"]
    x = _points(seed=8)
    want = jsdf.sdf_normals(jcfg.sdf_field, jp, jnp.asarray(x))
    got = tsdf.sdf_normals(tcfg.sdf_field, tp, _t(x))
    assert _rel(got, want) <= 1e-5
    with torch.no_grad():
        again = tsdf.sdf_normals(tcfg.sdf_field, tp, _t(x))
    assert torch.equal(again, got) and not again.requires_grad


def test_softplus_keeps_its_curve_above_the_threshold():
    """The SDF MLP's softplus is JAX's logaddexp(100 h, 0) / 100, with its
    derivative rule: values within an ulp, first derivatives equal, second
    within 1e-3 of the largest (25, at 0), and no NaN below 100 h = -88
    (torch.logaddexp's second derivative is NaN there); above 100 h = 20
    the slope is what JAX's is, not the 1 that F.softplus(beta=100)'s
    threshold would give from 20 on."""
    v = np.concatenate([np.linspace(-2.0, 2.0, 401), [0.0, 0.17, 0.25, 0.3]]
                       ).astype(np.float32)
    h = torch.from_numpy(v).requires_grad_(True)
    y = tsdf._softplus100(h)
    (g,) = torch.autograd.grad(y.sum(), h, create_graph=True)
    (g2,) = torch.autograd.grad(g.sum(), h)

    def f(x):
        return jnp.sum(jax.nn.softplus(100.0 * x) / 100.0)

    jv = jnp.asarray(v)
    jy = jax.nn.softplus(100.0 * jv) / 100.0
    jg = jax.grad(f)(jv)
    jg2 = jax.grad(lambda x: jnp.sum(jax.grad(f)(x)))(jv)
    assert np.abs(_np(y) - np.asarray(jy)).max() <= 2e-6
    assert np.abs(_np(g) - np.asarray(jg)).max() <= 1e-6
    assert np.isfinite(_np(g2)).all()
    assert np.abs(_np(g2) - np.asarray(jg2)).max() <= 1e-3 * 25.0
    assert float(g.detach()[-3]) == float(jg[-3])
    assert float(g2[-1]) == float(jg2[-1]) == 0.0


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_eval_chunk_matches_jax(setup):
    """One eval chunk (no draws): every output the JAX forward returns.

    The JAX model's section ends are swapped against NeuS's (its previous
    end is sdf + iter_cos * delta / 2, NeuS's sdf - iter_cos * delta / 2,
    and iter_cos is never positive), so prev_cdf <= next_cdf, and every
    alpha is (p + 1e-5) / (c + 1e-5) with p <= 0: at most ~1e-4, where p
    and 1e-5 nearly cancel.  The port keeps that (ROADMAP C), and the
    accumulation stays below 1e-3.  rgb and accumulation are held within
    1e-2 of their largest value (the cancellation magnifies the SDF's f32
    rounding differences ~100 times), the unit normals within 1e-3, depth
    (a median) at 95 % of the rays within 1e-3 relative, inv_s exact."""
    tcfg = setup["tcfg"]
    batch = _batch(2)
    want = setup["jax_eval"](jax.tree_util.tree_map(jnp.asarray, setup["np_tree"]),
                             {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        got = tneus.get_outputs(tcfg, convert.params_from_jax(setup["np_tree"], CPU),
                                _t(AABB), _port_rays(batch), train=False)
    assert set(got) == set(want)
    for k, tol in (("rgb", 1e-2), ("accumulation", 1e-2), ("normals", 1e-3)):
        assert got[k].shape == want[k].shape, k
        assert _rel(got[k], want[k]) <= tol, (k, _rel(got[k], want[k]))
    depth_rel = np.abs(_np(got["depth"]) - np.asarray(want["depth"])) / np.abs(
        np.asarray(want["depth"]))
    assert (depth_rel <= 1e-3).mean() >= 0.95
    assert float(got["inv_s"]) == pytest.approx(float(want["inv_s"]), rel=1e-6)
    acc = _np(got["accumulation"])
    assert 0.0 < acc.max() < 1e-3 and np.isfinite(_np(got["normals"])).all()


def _train_step(tcfg):
    cams = tcam.Cameras.create(**_camera_args(), device=CPU)
    return TrainStep(tcfg, cams, AABB, tmc.optimizer_configs["neus"],
                     device=CPU, model="neus",
                     camera_optimizer=tmc.camera_optimizer_configs["neus"])


@pytest.mark.parametrize("seed", [0, 3])
def test_train_step_matches_jax(setup, seed):
    """One whole train step against jax.value_and_grad with the same
    params, batch and jitters: the loss, rgb_loss, eikonal_loss, psnr and
    inv_s within 1e-4 relative; the gradient of every leaf before the
    update within 1e-2 in L2 (ROADMAP C.7: the colour head's bf16
    operands flip roundings, elementwise the leaves move by more).  The
    gradient reaches every SDF layer twice: through the sdf and through
    the normals (the colour head, the alphas and the eikonal loss read
    them), a double backward on the port's side."""
    tcfg = setup["tcfg"]
    batch = _batch(seed)
    key = jax.random.PRNGKey(11 + seed)
    jparams = jax.tree_util.tree_map(jnp.asarray, setup["np_tree"])
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, (jld, jmet)), jgrads = setup["jax_step"](jparams, jbatch, key)
    step = _train_step(tcfg)
    state = step.init_state(convert.params_from_jax(setup["np_tree"], CPU))
    loss, ld, met, grads = step.loss_and_grads(
        state, {k: _t(v) for k, v in batch.items()},
        train_proposal_networks=False,
        jitters=_jax_jitters(key, N_RAYS, tcfg))
    # JAX's aux dict comes back with sorted keys; the port's keeps the
    # order the total is summed in, JAX's too
    assert list(ld) == ["rgb_loss", "eikonal_loss"] and set(jld) == set(ld)
    assert set(met) == set(jmet) == {"psnr", "inv_s"}
    assert _rel(loss, jloss) <= 1e-4
    for k in jld:
        assert _rel(ld[k], jld[k]) <= 1e-4, k
    for k in jmet:
        assert _rel(met[k], jmet[k]) <= 1e-4, k
    names = []

    def walk(tree, path=()):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, path + (k,))
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                walk(v, path + (i,))
        else:
            names.append(path)

    walk(state.params)
    tgrads = dict(zip(names, grads))
    jflat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert len(jflat) == len(names)
    for path, jg in jflat:
        name = tuple(p.key if hasattr(p, "key") else p.idx for p in path)
        g = tgrads[name]
        assert g is not None and tuple(g.shape) == jg.shape, name
        assert np.abs(np.asarray(jg)).max() > 0.0, name
        assert _l2(g, jg) <= 1e-2, (name, _l2(g, jg))


def test_train_step_with_the_camera_optimizer_matches_jax(setup, monkeypatch):
    """The step above with the SO3xR3 camera optimizer on and non-zero pose
    adjustments: the pose's gradient reaches it through the samples'
    positions, the sdf and its normals (JAX's jax.grad of the sdf is
    differentiable in the positions; the port's double backward too).
    Each loss term within 1e-4 relative and every leaf, the pose's
    included, within 1e-2 in L2 (the tolerances above).

    Both sides take JAX's sampler bins (the port's sampler runs, and its
    bins are replaced by JAX's): the pose corrections' exp maps round a
    direction one ulp apart on the two sides (test_pose_corrected_rays_
    match_jax holds them to 1e-6), and NeuS's upsampling turns such a
    rounding into another importance sample on a ray now and then (one
    ray of 64 here), which moves the eikonal term by ~1e-3; the card's
    CPU check shares its bins the same way.  The bins are constants on
    both sides, so the gradients' paths are unchanged."""
    jcfg, tcfg = setup["jcfg"], setup["tcfg"]
    rng = np.random.default_rng(37)
    np_tree = dict(setup["np_tree"], camera_opt={"pose_adjustment": (
        rng.standard_normal((N_CAMS, 6)) * 0.02).astype(np.float32)})
    jcams = jcam.Cameras.create(**_camera_args())
    jcam_cfg = jco.CameraOptimizerConfig(mode="SO3xR3")
    aabb = jnp.asarray(AABB)
    batch = _batch(5)
    key = jax.random.PRNGKey(29)

    def jax_rays(p, batch):
        cam_opt = jco.apply_camera_optimizer(jcam_cfg, p["camera_opt"],
                                             batch["cam_idx"])
        return jcam.generate_rays(jcams, batch["cam_idx"], batch["coords"],
                                  cam_opt)

    @jax.jit
    def jax_step(params, batch):
        def loss_fn(p):
            outputs = jneus.get_outputs(jcfg, p, aabb, jax_rays(p, batch),
                                        rng=key, train=True)
            metrics = jneus.get_metrics_dict(jcfg, outputs, batch)
            loss_dict = jneus.get_loss_dict(jcfg, p, outputs, batch, metrics)
            return functools.reduce(jnp.add, loss_dict.values()), loss_dict

        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    @jax.jit
    def jax_bins(params, batch):
        rays = jax_rays(params, batch)
        n = rays.origins.shape[0]
        rays = rays.replace(nears=jnp.full((n,), jcfg.near_plane),
                            fars=jnp.full((n,), jcfg.far_plane))
        samples = jns.neus_sample(
            rays, lambda p: jsdf.sdf_value(jcfg.sdf_field, params["fields"], p),
            num_samples=jcfg.num_samples,
            num_samples_importance=jcfg.num_samples_importance,
            num_upsample_steps=jcfg.num_upsample_steps,
            base_variance=jcfg.base_variance, rng=jax.random.split(key)[0],
            stratified=True)
        return {f: getattr(samples, f) for f in
                ("starts", "ends", "spacing_starts", "spacing_ends")}

    jparams = jax.tree_util.tree_map(jnp.asarray, np_tree)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, jld), jgrads = jax_step(jparams, jbatch)
    bins = jax_bins(jparams, jbatch)
    sample = tneus.neus_sample

    def with_jax_bins(*args, **kwargs):
        out = sample(*args, **kwargs)
        return out.replace(**{f: _t(v).reshape(getattr(out, f).shape)
                              for f, v in bins.items()})

    monkeypatch.setattr(tneus, "neus_sample", with_jax_bins)
    groups = dict(tmc.optimizer_configs["neus"],
                  camera_opt=tmc.optimizer_configs["nerfacto"]["camera_opt"])
    step = TrainStep(tcfg, tcam.Cameras.create(**_camera_args(), device=CPU),
                     AABB, groups, device=CPU, model="neus",
                     camera_optimizer=tco.CameraOptimizerConfig(mode="SO3xR3"))
    state = step.init_state(convert.params_from_jax(np_tree, CPU))
    loss, ld, _met, grads = step.loss_and_grads(
        state, {k: _t(v) for k, v in batch.items()},
        train_proposal_networks=False, jitters=_jax_jitters(key, N_RAYS, tcfg))
    assert set(jld) == set(ld)
    assert _rel(loss, jloss) <= 1e-4
    for k in jld:
        assert _rel(ld[k], jld[k]) <= 1e-4, k
    names = []

    def walk(tree, path=()):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, path + (k,))
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                walk(v, path + (i,))
        else:
            names.append(path)

    walk(state.params)
    tgrads = dict(zip(names, grads))
    jflat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert len(jflat) == len(names)
    for path, jg in jflat:
        name = tuple(p.key if hasattr(p, "key") else p.idx for p in path)
        g = tgrads[name]
        assert g is not None and tuple(g.shape) == jg.shape, name
        assert _l2(g, jg) <= 1e-2, (name, _l2(g, jg))
    assert float(tgrads[("camera_opt", "pose_adjustment")].abs().max()) > 0


def test_eikonal_loss_reaches_the_params_through_the_normals(setup):
    """The eikonal term alone has a gradient in every SDF layer (the
    double backward), equal to JAX's within 1e-2 in L2."""
    jcfg, tcfg = setup["jcfg"], setup["tcfg"]
    x = _points(seed=9)
    jp = jax.tree_util.tree_map(jnp.asarray, setup["np_tree"])

    def jax_eik(p):
        g = jsdf.sdf_normals(jcfg.sdf_field, p["fields"], jnp.asarray(x))
        return jnp.mean((jnp.linalg.norm(g, axis=-1) - 1.0) ** 2)

    want = jax.grad(jax_eik)(jp)["fields"]["sdf_mlp"]["w"]
    tp = convert.params_from_jax(setup["np_tree"], CPU)
    ws = tp["fields"]["sdf_mlp"]["w"]
    for w in ws:
        w.requires_grad_(True)
    _, _, n = tsdf.sdf_features_and_normals(tcfg.sdf_field, tp["fields"], _t(x),
                                            create_graph=True)
    eik = torch.mean((torch.linalg.norm(n, dim=-1) - 1.0) ** 2)
    got = torch.autograd.grad(eik, ws)
    for g, jg in zip(got, want):
        assert float(g.abs().max()) > 0.0
        assert _l2(g, jg) <= 1e-2


def test_render_camera_gives_finite_normals_under_no_grad(setup):
    """render_camera (under no_grad, on the CPU) renders NeuS: the normals
    inside its forward come from a local enable_grad, the image is finite,
    and nothing it returns keeps a graph; RENDER_OUTPUTS stays JAX's render
    (rgb, depth, accumulation)."""
    tcfg = setup["tcfg"]
    params = convert.params_from_jax(setup["np_tree"], CPU)
    cams = tcam.Cameras.create(**_camera_args(), device=CPU)
    out = render_camera(tcfg, params, cams, 0, device=CPU, aabb=AABB,
                        model="neus")
    assert set(out) == {"rgb", "depth", "accumulation"}
    assert out["rgb"].shape == (H, W, 3)
    for v in out.values():
        assert torch.isfinite(v).all() and not v.requires_grad
    rays = tcam.generate_image_rays(cams, 0)
    with torch.no_grad():
        o = tneus.get_outputs(tcfg, params, _t(AABB), rays, train=False)
    assert torch.isfinite(o["normals"]).all() and not o["normals"].requires_grad
    # unit normals (the normalisation's + 1e-10 shortens a composite of
    # ~1e-7, whose weights are the reference's ~1e-5 alphas, by ~1e-3),
    # or 0 on a ray whose weights are all 0
    norm = np.linalg.norm(_np(o["normals"]), axis=-1)
    assert (np.abs(norm - 1.0) <= 1e-4).any() and (norm <= 1.0 + 1e-6).all()
    assert ((norm >= 0.99) | (norm == 0.0)).all()


def test_train_draws_have_the_samplers_shapes():
    _, tcfg = _configs()
    d = tneus.train_draws(tcfg, 10, torch.Generator().manual_seed(0), CPU)
    assert [tuple(j.shape) for j in d["jitters"]] == [(10, 1)] * 5
    assert d["background"] is None
    rand = dataclasses.replace(tcfg, background_color="random")
    d = tneus.train_draws(rand, 10, torch.Generator().manual_seed(0), CPU)
    assert tuple(d["background"].shape) == (10, 3)


def test_seeded_params_have_the_jax_layout_and_init():
    """seeded_params draws the JAX init's layout and distribution: the same
    tree and shapes, the sdf column's mean sqrt(pi / fan_in), the sdf bias
    -0.8, the deviation 0.1; the first layer reads the raw position only
    (its encoding rows zero), so the seeded SDF is ~|x| - 0.8: negative at
    radius 0.3, positive at radius 2 in every direction.  The
    registry-width field seeds the same way."""
    jcfg, tcfg = _configs()
    want = jax.tree_util.tree_map(lambda a: a.shape,
                                  jneus.init(jax.random.PRNGKey(0), jcfg, 0))
    tree = convert.seeded_params(tcfg, 0)
    assert jax.tree_util.tree_map(lambda a: a.shape, tree) == want
    f = tree["fields"]
    w0, wl, bl = f["sdf_mlp"]["w"][0], f["sdf_mlp"]["w"][-1], f["sdf_mlp"]["b"][-1]
    assert not w0[:-3].any() and w0[-3:].std() > 0
    assert abs(wl[:, 0].mean() - np.sqrt(np.pi / wl.shape[0])) < 1e-4
    assert bl[0] == np.float32(-0.8) and not bl[1:].any()
    assert f["deviation"].dtype == np.float32 and f["deviation"] == np.float32(0.1)
    for cfg in (tcfg, tmc.model_configs["neus"]):
        p = convert.params_from_jax(convert.seeded_params(cfg, 0), CPU)["fields"]
        dirs = _points(512, seed=10)
        dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
        with torch.no_grad():
            inner = tsdf.sdf_value(cfg.sdf_field, p, _t(0.3 * dirs))
            outer = tsdf.sdf_value(cfg.sdf_field, p, _t(2.0 * dirs))
        assert float(inner.max()) < 0.0 < float(outer.min())
    full = convert.seeded_params(tmc.model_configs["neus"], 0)
    assert [w.shape for w in full["fields"]["sdf_mlp"]["w"]] == [
        (39, 256)] + [(256, 256)] * 6 + [(256, 257)]


def test_registry_copy():
    """The port's neus: the JAX registry's model config field by field (the
    SDF field's too), its optimizer and schedule, 1024-ray batches on
    nerfstudio data."""
    jtc, ttc = method_configs["neus"], tmc.trainer_configs["neus"]
    jm, tm = jtc.pipeline.model, ttc.pipeline.model
    for f in dataclasses.fields(tm):
        if f.name == "sdf_field":
            assert dataclasses.asdict(tm.sdf_field) == dataclasses.asdict(jm.sdf_field)
        else:
            assert getattr(tm, f.name) == getattr(jm, f.name), f.name
    jopt, topt = jtc.optimizers["fields"], ttc.optimizers["fields"]
    assert (topt["optimizer"].lr, topt["optimizer"].eps) == (5e-4, 1e-15)
    assert (jopt["optimizer"].lr, jopt["optimizer"].eps) == (5e-4, 1e-15)
    sched = topt["scheduler"]
    assert dataclasses.asdict(sched) == dataclasses.asdict(jopt["scheduler"])
    assert ttc.pipeline.datamanager.train_num_rays_per_batch == 1024
    assert type(ttc.pipeline.datamanager.dataparser).__name__ == "NerfstudioDataParserConfig"
    assert ttc.mixed_precision is False and ttc.max_num_iterations == 100000
