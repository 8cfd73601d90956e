"""The port's classic NeRF methods (vanilla-nerf and dnerf, mipnerf, tensorf;
soccernerfs_tpu_torch/models/vanilla_nerf.py, mipnerf.py, tensorf.py) and
what they stand on, against the JAX package on the CPU: the NeRF,
integrated, CP, VM and triplane encodings and the conical frustum's
Gaussian; the VM tables' upsampling against ``jax.image.resize``; RAdam
against ``optax.scale_by_radam``; each field, one eval chunk and one whole
train step (loss terms and every gradient before the update) with the same
params, batch and draws; TensoRF's ``host_update`` against the JAX one at
an upsampling step, its optimizer reset included; a resume across an
upsample; the registry copies.

Small sizes: 64 rays from three cameras on +z, a few samples per ray, the
NeRF fields at their registry width (the model config does not reach it),
TensoRF at 16^3 tables growing to 24^3 with 4 density and 6 colour
components.  Torch cannot reproduce JAX's PRNG streams: the tests make
JAX's own jitter draws and hand them to the port.  Inputs are made with
numpy from a seed; every tolerance is stated with its reason.
"""
import copy
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
from soccernerfs_tpu.engine import optimizers as jopt
from soccernerfs_tpu.engine.trainer import TrainState as JaxTrainState
from soccernerfs_tpu.fields import vanilla_nerf as jvf
from soccernerfs_tpu.models import mipnerf as jmip
from soccernerfs_tpu.models import tensorf as jtf
from soccernerfs_tpu.models import vanilla_nerf as jvn
from soccernerfs_tpu.ops import encodings as jenc
from soccernerfs_tpu_torch import convert
from soccernerfs_tpu_torch.configs import method_configs as tmc
from soccernerfs_tpu_torch.core import cameras as tcam
from soccernerfs_tpu_torch.data.dataparsers.blender import BlenderDataParserConfig
from soccernerfs_tpu_torch.data.fixtures import make_blender_fixture
from soccernerfs_tpu_torch.engine import optimizers as topt
from soccernerfs_tpu_torch.engine.trainer import Trainer, TrainStep
from soccernerfs_tpu_torch.fields import vanilla_nerf as tvf
from soccernerfs_tpu_torch.models import get_model
from soccernerfs_tpu_torch.models import mipnerf as tmip
from soccernerfs_tpu_torch.models import tensorf as ttf
from soccernerfs_tpu_torch.models import vanilla_nerf as tvn
from soccernerfs_tpu_torch.ops import encodings as tenc
from soccernerfs_tpu_torch.utils.tree import tree_leaves


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
_TENSORF = dict(init_resolution=16, final_resolution=24,
                upsampling_iters=(2, 4), num_den_components=4,
                num_color_components=6, num_uniform_samples=16,
                num_samples=8, eval_num_rays_per_chunk=32)
# method -> (JAX model module, port model module, small config overrides)
SMALL = {
    "vanilla-nerf": (jvn, tvn, dict(num_coarse_samples=8,
                                    num_importance_samples=8,
                                    eval_num_rays_per_chunk=32)),
    "mipnerf": (jmip, tmip, dict(num_coarse_samples=8,
                                 num_importance_samples=8,
                                 eval_num_rays_per_chunk=32)),
    "tensorf-vm": (jtf, ttf, dict(tensorf_encoding="vm", **_TENSORF)),
    "tensorf-cp": (jtf, ttf, dict(tensorf_encoding="cp", **_TENSORF)),
    "tensorf-triplane": (jtf, ttf, dict(tensorf_encoding="triplane",
                                        **_TENSORF)),
}


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


def _walk(tree, fn, path=()):
    if isinstance(tree, dict):
        return {k: _walk(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_walk(v, fn, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def _camera_args():
    """Three cameras on +z, 4 from the origin, looking down -z: their rays
    cross the NeRF methods' planes at 2 and 6 and the scene box."""
    c2w = np.tile(np.eye(3, 4, dtype=np.float32)[None], (N_CAMS, 1, 1))
    c2w[:, :, 3] = [[0.2, -0.1, 4.0], [-0.3, 0.2, 3.8], [0.0, 0.1, 4.2]]
    return dict(camera_to_worlds=c2w, fx=7.0, fy=7.5, cx=4.1, cy=3.9,
                width=W, height=H, times=np.array([0.05, 0.5, 0.93], np.float32))


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "cam_idx": rng.integers(0, N_CAMS, N_RAYS).astype(np.int32),
        "coords": rng.uniform(0, H, (N_RAYS, 2)).astype(np.float32),
        "image": rng.uniform(0, 1, (N_RAYS, 3)).astype(np.float32),
    }


def _configs(name):
    jm, tm, small = SMALL[name]
    method = name.split("-")[0] if name.startswith("tensorf") else name
    jcfg = dataclasses.replace(method_configs[method].pipeline.model, **small)
    tcfg = dataclasses.replace(tmc.model_configs[method], **small)
    return method, jm, tm, jcfg, tcfg


def _jax_draws(key, n, tm, tcfg):
    """The JAX forward's jitters: get_outputs splits its key into (coarse,
    PDF, background) keys; each sampler draws uniform [N, S + 1], or
    [N, 1] with a single jitter (TensoRF)."""
    rng_u, rng_pdf, _ = jax.random.split(key, 3)
    single = tm is ttf
    return [_t(jax.random.uniform(k, (n, 1 if single else s + 1)))
            for k, s in zip((rng_u, rng_pdf), tm.sample_counts(tcfg))]


# TensoRF's density tables are offset by these: from N(0, 0.1^2) tables
# alone the summed products are ~1e-3 and the rays stay empty
_DENSITY_OFFSET = {"vm": 0.15, "cp": 0.42, "triplane": 0.025}


def _lifted(np_tree, cfg):
    """The JAX init's tree with each NeRF density head's bias set to 0.3
    (at the init's own bias the ReLU density is 0 at most samples, and
    nothing reaches the rays' weights) and TensoRF's density tables offset
    (``_DENSITY_OFFSET``), so that the rays' accumulations lie between 0
    and 1."""

    def lift(path, x):
        x = np.array(x)
        if "density_head" in path and path[-2] == "b":
            x[...] = 0.3
        if path[:2] == ("encodings", "density"):
            x = x + np.float32(_DENSITY_OFFSET[cfg.tensorf_encoding])
        return x

    return _walk(np_tree, lift)


@pytest.fixture(scope="module", params=list(SMALL))
def setup(request):
    name = request.param
    method, jm, tm, jcfg, tcfg = _configs(name)
    np_tree = _lifted(jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(0), jcfg, N_CAMS)), jcfg)
    jcams = jcam.Cameras.create(**_camera_args())
    aabb = jnp.asarray(AABB)

    @jax.jit
    def jax_step(params, batch, key, shift):
        """The loss_fn of the JAX Trainer's step; with ``shift`` 1, every
        other component of the rays' directions one f32 ulp up (the step's
        own sensitivity to rounding)."""

        def loss_fn(p):
            rays = jcam.generate_rays(jcams, batch["cam_idx"], batch["coords"])
            d = rays.directions
            every_other = (jnp.arange(d.size) % 2 == 0).reshape(d.shape)
            rays = rays.replace(directions=jnp.where(
                every_other & (shift > 0), jnp.nextafter(d, 2.0), d))
            outputs = jm.get_outputs(jcfg, p, aabb, rays, rng=key, train=True)
            metrics = jm.get_metrics_dict(jcfg, outputs, batch)
            loss_dict = jm.get_loss_dict(jcfg, p, outputs, batch, metrics)
            return functools.reduce(jnp.add, loss_dict.values()), (
                loss_dict, metrics)

        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    @jax.jit
    def jax_eval(params, batch):
        rays = jcam.generate_rays(jcams, batch["cam_idx"], batch["coords"])
        return jm.get_outputs(jcfg, params, aabb, rays, rng=None, train=False)

    return dict(name=name, method=method, jm=jm, tm=tm, jcfg=jcfg, tcfg=tcfg,
                np_tree=np_tree, jax_step=jax_step, jax_eval=jax_eval)


def _train_step(method, tcfg):
    cams = tcam.Cameras.create(**_camera_args(), device=CPU)
    return TrainStep(tcfg, cams, AABB, tmc.optimizer_configs[method],
                     device=CPU, model=tmc.model_names[method],
                     camera_optimizer=tmc.camera_optimizer_configs[method])


# ---------------------------------------------------------------------------
# encodings
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("freqs,top", [(10, 8.0), (4, 4.0), (16, 16.0), (2, 2.0)])
@pytest.mark.parametrize("integrated", [False, True])
def test_nerf_encoding_matches_jax(freqs, top, integrated):
    """The NeRF encoding of points in [-1.5, 1.5]^3 at the registry's
    frequency counts, and mip-NeRF's integrated one over random
    covariances, to 1e-6 absolute (sines of f32 arguments: both sides
    scale by the same f32 frequencies, XLA's linspace rounding kept)."""
    rng = np.random.default_rng(freqs)
    x = rng.uniform(-1.5, 1.5, (512, 3)).astype(np.float32)
    a = rng.normal(0, 0.02, (512, 3, 3)).astype(np.float32)
    covs = np.einsum("nij,nkj->nik", a, a).astype(np.float32) if integrated else None
    want = np.asarray(jenc.nerf_encoding(
        jnp.asarray(x), freqs, 0.0, top, include_input=True,
        covs=None if covs is None else jnp.asarray(covs)))
    got = tenc.nerf_encoding(_t(x), freqs, 0.0, top, include_input=True,
                             covs=None if covs is None else _t(covs))
    assert got.shape == want.shape == (512, 3 * freqs * 2 + 3)
    assert np.abs(_np(got) - want).max() <= 1e-6


@pytest.mark.parametrize("kind", ["cp", "vm", "triplane"])
def test_tensor_encodings_match_jax(kind):
    """CP, VM and triplane features of points in [-1.1, 1.1]^3 (some
    outside: the lookups clamp to the border) and their gradients in the
    tables, to 1e-6 of the largest value.  The planes are gathered as bf16
    on both sides; the table gradients accumulate in bf16 in the same
    (sequential) order on both CPU sides."""
    rng = np.random.default_rng(3)
    tables = {"cp": {"line_coef": (3, 12, 5)},
              "vm": {"plane_coef": (3, 12, 12, 5), "line_coef": (3, 12, 5)},
              "triplane": {"plane_coef": (3, 12, 12, 5)}}[kind]
    params = {k: rng.normal(0, 0.3, s).astype(np.float32) for k, s in tables.items()}
    x = rng.uniform(-1.1, 1.1, (300, 3)).astype(np.float32)
    cot = rng.normal(0, 1, (300, 15 if kind == "vm" else 5)).astype(np.float32)
    jfn = {"cp": jenc.tensor_cp_encoding, "vm": jenc.tensor_vm_encoding,
           "triplane": jenc.triplane_encoding}[kind]
    tfn = {"cp": tenc.tensor_cp_encoding, "vm": tenc.tensor_vm_encoding,
           "triplane": tenc.triplane_encoding}[kind]
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    want, vjp = jax.vjp(lambda p: jfn(p, jnp.asarray(x)), jp)
    (jgrad,) = vjp(jnp.asarray(cot))
    tp = {k: _t(v).requires_grad_(True) for k, v in params.items()}
    got = tfn(tp, _t(x))
    got.backward(_t(cot))
    assert got.shape == want.shape
    assert _rel(got, want) <= 1e-6
    for k in params:
        assert _rel(tp[k].grad, jgrad[k]) <= 1e-6, k


@pytest.mark.parametrize("kind", ["cp", "vm", "triplane"])
def test_tensor_inits_have_the_jax_layout(kind):
    """The port's inits draw N(0, 0.1^2) tables of the JAX init's shapes."""
    make_t = {"cp": tenc.init_tensor_cp, "vm": tenc.init_tensor_vm,
              "triplane": tenc.init_triplane}[kind]
    make_j = {"cp": jenc.init_tensor_cp, "vm": jenc.init_tensor_vm,
              "triplane": jenc.init_triplane}[kind]
    got = make_t(20, 7, generator=torch.Generator().manual_seed(0))
    want = make_j(jax.random.PRNGKey(0), 20, 7)
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: v.shape for k, v in want.items()}
    for v in got.values():
        assert abs(float(v.std()) - 0.1) < 0.01 and abs(float(v.mean())) < 0.01


@pytest.mark.parametrize("size", [(5, 8), (16, 24), (128, 150), (252, 300)])
def test_upsample_tensor_vm_matches_jax_image_resize(size):
    """upsample_tensor_vm against jax.image.resize(..., "bilinear"): every
    entry to 1e-6 of the largest, the border rows and columns held on
    their own (half-pixel centres replicate the border; a corner-aligned
    resize would differ there), at the registry's schedule steps too."""
    old, new = size
    rng = np.random.default_rng(old)
    grids = {"plane_coef": rng.normal(0, 1, (3, old, old, 4)).astype(np.float32),
             "line_coef": rng.normal(0, 1, (3, old, 4)).astype(np.float32)}
    want = jenc.upsample_tensor_vm({k: jnp.asarray(v) for k, v in grids.items()}, new)
    got = tenc.upsample_tensor_vm({k: _t(v) for k, v in grids.items()}, new)
    for k in grids:
        w, g = np.asarray(want[k]), _np(got[k])
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= 1e-6 * np.abs(w).max(), k
    wp, gp = np.asarray(want["plane_coef"]), _np(got["plane_coef"])
    for border in (np.s_[:, 0], np.s_[:, -1], np.s_[:, :, 0], np.s_[:, :, -1]):
        assert np.abs(gp[border] - wp[border]).max() <= 1e-6 * np.abs(wp).max()
    wl, gl = np.asarray(want["line_coef"]), _np(got["line_coef"])
    assert np.abs(gl[:, [0, -1]] - wl[:, [0, -1]]).max() <= 1e-6 * np.abs(wl).max()
    # a corner-aligned resize (the nerfstudio original's) is another one
    aligned = torch.nn.functional.interpolate(
        _t(grids["plane_coef"]).permute(0, 3, 1, 2), size=(new, new),
        mode="bilinear", align_corners=True).permute(0, 2, 3, 1).numpy()
    assert np.abs(aligned - wp).max() > 1e-2


def test_upsample_refuses_a_downsample():
    grids = {"plane_coef": torch.zeros(3, 8, 8, 2), "line_coef": torch.zeros(3, 8, 2)}
    with pytest.raises(ValueError, match="upsampl"):
        tenc.upsample_tensor_vm(grids, 6)


def test_conical_frustum_to_gaussian_matches_jax():
    """mip-NeRF's frustum Gaussians of random frusta to 1e-6 of each
    output's largest value."""
    rng = np.random.default_rng(5)
    n = 256
    d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    starts = rng.uniform(2, 5, (n, 1)).astype(np.float32)
    ends = starts + rng.uniform(0.01, 0.5, (n, 1)).astype(np.float32)
    radius = rng.uniform(1e-4, 1e-2, (n, 1)).astype(np.float32)
    jm, jc = jenc.conical_frustum_to_gaussian(*map(jnp.asarray, (o, d, starts, ends, radius)))
    tm, tc = tenc.conical_frustum_to_gaussian(*map(_t, (o, d, starts, ends, radius)))
    assert _rel(tm, jm) <= 1e-6 and _rel(tc, jc) <= 1e-6


# ---------------------------------------------------------------------------
# RAdam
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("weight_decay", [0.0, 1e-2])
def test_radam_matches_optax(weight_decay):
    """Ten RAdam updates (the switch from the plain first moment to the
    rectified update comes at count 6) of three leaves against the JAX
    package's chain (optax.scale_by_radam, then the schedule), with the
    same gradients: every leaf after every update, and the moments, to
    1e-6 relative to the leaf's largest entry (f32 arithmetic in the same
    order; b^t rounded as XLA rounds it)."""
    cfg_j = jopt.RAdamOptimizerConfig(lr=5e-4, eps=1e-8, weight_decay=weight_decay)
    cfg_t = topt.RAdamOptimizerConfig(lr=5e-4, eps=1e-8, weight_decay=weight_decay)
    rng = np.random.default_rng(7)
    shapes = [(6, 5), (5,), (4, 3, 2)]
    params = [rng.normal(0, 1, s).astype(np.float32) for s in shapes]
    tx = jopt.build_group_optimizer(cfg_j, None)
    jp = [jnp.asarray(p) for p in params]
    jstate = tx.init(jp)
    leaves = [_t(p) for p in params]
    tstate = topt.adam_init(cfg_t, leaves)
    schedule = topt.schedule_fn(None, cfg_t.lr)
    for i in range(10):
        grads = [rng.normal(0, 1 + i, s).astype(np.float32) for s in shapes]
        upd, jstate = tx.update([jnp.asarray(g) for g in grads], jstate, jp)
        jp = optax.apply_updates(jp, upd)
        topt.group_update(cfg_t, schedule, tstate, leaves, [_t(g) for g in grads])
        for a, b in zip(leaves, jp):
            assert _rel(a, b) <= 1e-6, (i, _rel(a, b))
    (radam_state,) = [s for s in jstate if hasattr(s, "nu")]
    assert tstate.count == int(radam_state.count) == 10
    for a, b in zip(tstate.mu + tstate.nu, list(radam_state.mu) + list(radam_state.nu)):
        assert _rel(a, b) <= 1e-6


def test_radam_switches_at_count_6():
    """Before count 6 the update is the bias-corrected first moment (its
    size the lr whatever the gradient's scale); from count 6 on it is
    rectified, and scales like Adam's."""
    cfg = topt.RAdamOptimizerConfig(lr=1.0)
    sched = topt.schedule_fn(None, 1.0)
    p = [torch.zeros(4)]
    state = topt.adam_init(cfg, p)
    moves = []
    for _ in range(7):
        before = p[0].clone()
        topt.radam_update(cfg, sched, state, p, [torch.full((4,), 1e-3)])
        moves.append(float((before - p[0])[0]))
    np.testing.assert_allclose(moves[:5], 1e-3, rtol=1e-5)
    assert moves[5] > 0.01 and moves[6] > 0.01


# ---------------------------------------------------------------------------
# fields, eval chunks and train steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("integrated", [False, True])
def test_nerf_field_matches_jax(integrated):
    """The 8 x 256 NeRF field's density and rgb at random points, with the
    integrated encoding over random covariances too: within 1e-3 of their
    largest values, and exact to 1e-6 at 95 % of the points.  Each of the
    ten layers rounds its operands to bf16 on both sides; a sum that XLA
    and torch round differently in f32 can flip one of those roundings (a
    2^-8 step), which the layers after it carry to the output at ~2 % of
    the points."""
    fcfg_j = jvf.NeRFFieldConfig(use_integrated_encoding=integrated)
    fcfg_t = tvf.NeRFFieldConfig(use_integrated_encoding=integrated)
    params = jax.tree_util.tree_map(np.asarray, jvf.init_nerf_field(
        jax.random.PRNGKey(1), fcfg_j))
    rng = np.random.default_rng(11)
    x = rng.uniform(-1.5, 1.5, (256, 3)).astype(np.float32)
    d = rng.normal(0, 1, (256, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    a = rng.normal(0, 0.05, (256, 3, 3)).astype(np.float32)
    covs = np.einsum("nij,nkj->nik", a, a).astype(np.float32)
    jd, jr = jvf.nerf_field_forward(fcfg_j, jax.tree_util.tree_map(jnp.asarray, params),
                                    jnp.asarray(x), jnp.asarray(d), jnp.asarray(covs))
    td, tr = tvf.nerf_field_forward(fcfg_t, convert.params_from_jax(params, CPU),
                                    _t(x), _t(d), _t(covs))
    assert float(jnp.max(jd)) > 0
    assert _rel(td, jd) <= 1e-3 and _rel(tr, jr) <= 1e-3
    assert (np.abs(_np(td) - np.asarray(jd)) > 1e-6).mean() <= 0.05


@pytest.mark.parametrize("name", ["tensorf-vm", "tensorf-cp", "tensorf-triplane"])
def test_tensorf_density_and_rgb_match_jax(name):
    """TensoRF's density and colour at random points of the scene box, a
    few outside it, for each encoding: densities within 1e-5 and colours
    within 1e-4 of their largest values (bf16 plane gathers on both sides;
    the colour's head rounds its operands to bf16)."""
    _method, jm, _tm, jcfg, tcfg = _configs(name)
    np_tree = jax.tree_util.tree_map(np.asarray,
                                     jm.init(jax.random.PRNGKey(0), jcfg, N_CAMS))
    rng = np.random.default_rng(2)
    x = rng.uniform(-1.6, 1.6, (300, 3)).astype(np.float32)
    d = rng.normal(0, 1, (300, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    jp = jax.tree_util.tree_map(jnp.asarray, np_tree)
    tp = convert.params_from_jax(np_tree, CPU)
    aabb = jnp.asarray(AABB)
    jd = jtf._density(jcfg, jp, aabb, jnp.asarray(x))
    jr = jtf._rgb(jcfg, jp, aabb, jnp.asarray(x), jnp.asarray(d))
    td = ttf.density(tcfg, tp, _t(AABB), _t(x))
    tr = ttf.rgb(tcfg, tp, _t(AABB), _t(x), _t(d))
    assert float(jnp.max(jd)) > 0
    assert _rel(td, jd) <= 1e-5 and _rel(tr, jr) <= 1e-4


def test_eval_chunk_matches_jax(setup):
    """One eval chunk (no draws): every output the JAX forward returns
    (rgb, accumulation and depth, of both passes where it has them) within
    1e-3 of its largest value: the ten bf16 layers of a NeRF field flip a
    rounding at ~2 % of the samples (test_nerf_field_matches_jax), and the
    PDF bins move with the coarse weights."""
    tm, tcfg = setup["tm"], setup["tcfg"]
    batch = _batch(1)
    want = setup["jax_eval"](jax.tree_util.tree_map(jnp.asarray, setup["np_tree"]),
                             {k: jnp.asarray(v) for k, v in batch.items()})
    cams = tcam.Cameras.create(**_camera_args(), device=CPU)
    rays = tcam.generate_rays(cams, _t(batch["cam_idx"]), _t(batch["coords"]))
    with torch.no_grad():
        got = tm.get_outputs(tcfg, convert.params_from_jax(setup["np_tree"], CPU),
                             _t(AABB), rays, train=False)
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert _rel(got[k], want[k]) <= 1e-3, (k, _rel(got[k], want[k]))
    acc = _np(got["accumulation"])
    assert 0.01 < acc.mean() < 0.99


def test_train_step_matches_jax(setup):
    """One whole train step against jax.value_and_grad with the same
    params, batch and jitters: the loss, every loss term and PSNR within
    1e-4 relative; the gradient of every leaf before the update within
    1e-2 in L2, or within twice the JAX step's own one-ulp witness where
    that is larger.

    The witness is the JAX step again with every other component of the
    ray directions one f32 ulp up.  Vanilla NeRF's first layers move by up
    to ~0.13 in L2 under it: the PDF sampler turns rounding differences of
    the coarse weights into moves of ~1e-5 of the fine samples, the top
    frequency (2^8 * 2 pi) carries them into the encodings, and the bf16
    operand roundings of ten layers turn those into flipped 2^-8 steps.
    Card-free rounding differences between XLA and torch are of the same
    kind, so those leaves are held to the witness; every other leaf, and
    every leaf of mip-NeRF (damped top frequencies) and TensoRF, to 1e-2.
    L2 per leaf, not per element, for the same reason, and because
    TensoRF's table gradients accumulate in bf16 (as the JAX package's
    gather transposes do)."""
    method, tm, tcfg = setup["method"], setup["tm"], setup["tcfg"]
    batch = _batch()
    key = jax.random.PRNGKey(11)
    jparams = jax.tree_util.tree_map(jnp.asarray, setup["np_tree"])
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, (jld, jmet)), jgrads = setup["jax_step"](jparams, jbatch, key, 0)
    _, wgrads = setup["jax_step"](jparams, jbatch, key, 1)
    step = _train_step(method, tcfg)
    state = step.init_state(convert.params_from_jax(setup["np_tree"], CPU))
    loss, ld, met, grads = step.loss_and_grads(
        state, {k: _t(v) for k, v in batch.items()},
        train_proposal_networks=False,
        jitters=_jax_draws(key, N_RAYS, tm, tcfg))
    assert list(ld) == list(jld) and set(met) == set(jmet) == {"psnr"}
    assert _rel(loss, jloss) <= 1e-4
    for k in jld:
        assert _rel(ld[k], jld[k]) <= 1e-4, k
    assert _rel(met["psnr"], jmet["psnr"]) <= 1e-4
    names = []
    _walk(state.params, lambda path, x: names.append(path))
    tgrads = dict(zip(names, grads))
    jflat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert len(jflat) == len(names)
    held_to_witness = []
    for (path, jg), wg in zip(jflat, jax.tree_util.tree_leaves(wgrads)):
        name = tuple(p.key if hasattr(p, "key") else p.idx for p in path)
        g = tgrads[name]
        assert g is not None and tuple(g.shape) == jg.shape, name
        assert np.abs(np.asarray(jg)).max() > 0.0, name
        bound = max(1e-2, 2 * _l2(wg, jg))
        if bound > 1e-2:
            held_to_witness.append(name)
        assert _l2(g, jg) <= bound, (name, _l2(g, jg), bound)
    if method != "vanilla-nerf":
        assert not held_to_witness


def test_train_iteration_draws_and_updates(setup):
    """train_iteration: the draws have the samplers' shapes, every param
    group moves (RAdam's first update is the lr-sized first moment), the
    loss is finite."""
    method, tm, tcfg = setup["method"], setup["tm"], setup["tcfg"]
    draws = tm.train_draws(tcfg, 5, torch.Generator().manual_seed(0), CPU)
    single = tm is ttf
    assert [tuple(j.shape) for j in draws["jitters"]] == [
        (5, 1 if single else s + 1) for s in tm.sample_counts(tcfg)]
    assert draws["background"] is None
    step = _train_step(method, tcfg)
    state = step.init_state(convert.params_from_jax(setup["np_tree"], CPU))
    before = [x.detach().clone() for x in tree_leaves(state.params)]
    out = step.train_iteration(state, {k: _t(v) for k, v in _batch(2).items()},
                               torch.Generator().manual_seed(1))
    assert np.isfinite(float(out["Train Loss"])) and state.step == 1
    moved = [not torch.equal(a, b.detach()) for a, b in
             zip(before, tree_leaves(state.params))]
    assert all(moved)


# ---------------------------------------------------------------------------
# TensoRF's upsampling and the trainer
# ---------------------------------------------------------------------------

def test_upsampling_schedule_matches_jax():
    for cfg in (tmc.model_configs["tensorf"], ttf.Config(**_TENSORF)):
        jcfg = jtf.Config(**{f.name: getattr(cfg, f.name)
                             for f in dataclasses.fields(cfg)})
        assert cfg.upsampling_resolutions() == jcfg.upsampling_resolutions()
    cfg = tmc.model_configs["tensorf"]
    res = cfg.upsampling_resolutions()
    assert list(res) == [2000, 3000, 4000, 5500, 7000] and res[7000] == 300
    assert [cfg.resolution_at(s) for s in (0, 1999, 2000, 6999, 10_000)] == [
        128, 128, res[2000], res[5500], 300]


def test_host_update_matches_jax():
    """tensorf's host_update at an upsampling step against the JAX one:
    the upsampled tables within 1e-6, the other leaves the same objects'
    values, and the optimizer state of both groups rebuilt (count 0, zero
    moments); then one update with the same gradients on both sides
    lands on the same params within 1e-6 relative: both groups'
    exponential decays restarted (the first update's lr is the initial
    one), as optax's rebuilt state has it.  Off the schedule (and for CP)
    it returns None."""
    method, jm, tm, jcfg, tcfg = _configs("tensorf-vm")
    np_tree = jax.tree_util.tree_map(np.asarray,
                                     jm.init(jax.random.PRNGKey(0), jcfg, N_CAMS))
    ref = method_configs["tensorf"].optimizers
    opt = jopt.build_optimizers(ref, tuple(np_tree))
    rng = np.random.default_rng(4)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_tree)
    jstate = JaxTrainState(params=jparams, opt_state=opt.init(jparams),
                           step=jnp.asarray(2, jnp.int32), aux={})
    # move both optimizer states well away from their init: 3 updates
    step = _train_step(method, tcfg)
    state = step.init_state(convert.params_from_jax(np_tree, CPU))
    for _ in range(3):
        g = jax.tree_util.tree_map(
            lambda x: rng.normal(0, 1, x.shape).astype(np.float32), np_tree)
        upd, os_ = opt.update(jax.tree_util.tree_map(jnp.asarray, g),
                              jstate.opt_state, jstate.params)
        jstate = jstate.replace(params=optax.apply_updates(jstate.params, upd),
                                opt_state=os_)
        step.apply_grads(state, [_t(x) for x in tree_leaves(g)])
    assert tm.host_update(tcfg, state, 3, step.init_opt_state) is None
    assert jm.host_update(jcfg, jstate, 3, opt) is None

    jnew = jm.host_update(jcfg, jstate, 2, opt)
    tnew = tm.host_update(tcfg, state, 2, step.init_opt_state)
    assert tnew is not None and tnew.step == state.step
    for path, jleaf in jax.tree_util.tree_flatten_with_path(jnew.params)[0]:
        name = tuple(p.key if hasattr(p, "key") else p.idx for p in path)
        leaf = functools.reduce(lambda t, k: t[k], name, tnew.params)
        assert leaf.shape == jleaf.shape and leaf.requires_grad, name
        assert _rel(leaf, jleaf) <= 1e-6, name
    assert tnew.params["encodings"]["density"]["plane_coef"].shape[1] == 20
    assert tnew.params["fields"] is state.params["fields"]
    for name, o in tnew.opt_state.items():
        assert o.count == 0 and all(float(m.abs().max()) == 0 for m in o.mu + o.nu)
    counts = [int(c) for c in jax.tree_util.tree_leaves(jnew.opt_state)
              if getattr(c, "shape", None) == () and c.dtype == jnp.int32]
    assert counts and set(counts) == {0}

    g = jax.tree_util.tree_map(lambda x: rng.normal(0, 1, x.shape).astype(np.float32),
                               jax.tree_util.tree_map(np.asarray, jnew.params))
    upd, _ = opt.update(jax.tree_util.tree_map(jnp.asarray, g), jnew.opt_state,
                        jnew.params)
    want = optax.apply_updates(jnew.params, upd)
    step.apply_grads(tnew, [_t(x) for x in tree_leaves(g)])
    for a, b in zip(tree_leaves(tnew.params), jax.tree_util.tree_leaves(want)):
        assert _rel(a, b) <= 1e-6
    # the first update after the reset moves by the initial lr (Adam's
    # first step is lr-sized): 0.02 for the tables, 0.001 for the fields
    moved = np.abs(_np(tnew.params["encodings"]["color"]["line_coef"])
                   - np.asarray(jnew.params["encodings"]["color"]["line_coef"]))
    np.testing.assert_allclose(moved.max(), 0.02, rtol=1e-3)
    cp_cfg = dataclasses.replace(tcfg, tensorf_encoding="cp")
    assert tm.host_update(cp_cfg, state, 2, step.init_opt_state) is None


@pytest.fixture(scope="module")
def blender_root(tmp_path_factory):
    return make_blender_fixture(tmp_path_factory.mktemp("blender"), h=12, w=16)


def _tensorf_trainer(tmp_path, blender_root, name, load_dir=None, steps=6):
    cfg = copy.deepcopy(tmc.trainer_configs["tensorf"])
    cfg.pipeline.model = dataclasses.replace(
        cfg.pipeline.model, **{**_TENSORF, "init_resolution": 8,
                               "final_resolution": 12})
    dm = cfg.pipeline.datamanager
    dm.train_num_rays_per_batch = 32
    dm.eval_num_rays_per_batch = 16
    dm.dataparser = BlenderDataParserConfig(data=blender_root)
    cfg.max_num_iterations = steps
    cfg.steps_per_save = 0
    cfg.steps_per_eval_batch = 0
    cfg.steps_per_eval_image = 0
    cfg.steps_per_eval_all_images = 0
    cfg.vis = "none"
    cfg.output_dir = tmp_path / name
    cfg.set_timestamp()
    cfg.load_dir = load_dir
    return Trainer(cfg, device=CPU).setup()


def _run(trainer, steps):
    losses = []
    for step in steps:
        trainer.datamanager.train_pixel_sampler.rng = np.random.default_rng(
            9000 + step)
        losses.append(float(trainer.train_iteration(step)["Train Loss"]))
    return losses


def test_trainer_upsamples_and_resumes_across_an_upsample(tmp_path, blender_root):
    """Trainer.train_iteration runs host_update before each step: the
    tables grow 8 -> 10 at step 2 and -> 12 at step 4, and every group's
    optimizer state restarts there.  A run checkpointed after step 2 (the
    larger tables) and resumed is bit-equal to the uninterrupted one at
    step 6."""
    full = _tensorf_trainer(tmp_path, blender_root, "full")
    shapes = []
    counts = []
    for step in range(6):
        _run(full, [step])
        shapes.append(full.state.params["encodings"]["density"]["plane_coef"].shape[1])
        counts.append({k: o.count for k, o in full.state.opt_state.items()})
    assert shapes == [8, 8, 10, 10, 12, 12]
    assert [c["encodings"] for c in counts] == [1, 2, 1, 2, 1, 2]
    assert [c["fields"] for c in counts] == [1, 2, 1, 2, 1, 2]

    first = _tensorf_trainer(tmp_path, blender_root, "first")
    _run(first, range(3))
    first.save_checkpoint(2)
    resumed = _tensorf_trainer(tmp_path, blender_root, "resumed",
                               load_dir=first.base_dir)
    assert resumed.state.step == 3
    assert resumed.state.params["encodings"]["color"]["line_coef"].shape[1] == 10
    _run(resumed, range(3, 6))
    for a, b in zip(tree_leaves(resumed.state.params),
                    tree_leaves(full.state.params), strict=True):
        assert torch.equal(a.detach(), b.detach())
    for name, o in resumed.state.opt_state.items():
        p = full.state.opt_state[name]
        assert o.count == p.count
        assert all(torch.equal(x, y) for x, y in zip(o.mu + o.nu, p.mu + p.nu))


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["vanilla-nerf", "dnerf", "mipnerf", "tensorf"])
def test_registry_copies(method):
    """The model configs equal the JAX registry's field by field, the
    models are registered under the JAX names, and the seeded params have
    the JAX init's layout (TensoRF's at the final resolution past step
    7000)."""
    jcfg = method_configs[method].pipeline.model
    tcfg = tmc.model_configs[method]
    assert {f.name: getattr(tcfg, f.name) for f in dataclasses.fields(tcfg)} == {
        f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    assert tmc.model_names[method] == method_configs[method].pipeline.model_name
    assert get_model(tmc.model_names[method]).Config is type(tcfg)
    small = dataclasses.replace(tcfg, **SMALL[
        "tensorf-vm" if method == "tensorf" else
        ("mipnerf" if method == "mipnerf" else "vanilla-nerf")][2])
    jsmall = dataclasses.replace(jcfg, **{f.name: getattr(small, f.name)
                                          for f in dataclasses.fields(small)})
    jm = SMALL["tensorf-vm" if method == "tensorf" else
               ("mipnerf" if method == "mipnerf" else "vanilla-nerf")][0]
    want = jax.tree_util.tree_map(lambda x: x.shape,
                                  jm.init(jax.random.PRNGKey(0), jsmall, 0))
    got = jax.tree_util.tree_map(lambda x: x.shape,
                                 convert.seeded_params(small, 0))
    assert got == want
    if method == "tensorf":
        late = convert.seeded_params(small, 0, step=10_000)
        assert late["encodings"]["color"]["plane_coef"].shape[1] == 24
    assert method in tmc.trainer_configs


def test_not_ported_is_the_rest():
    """Nothing of the JAX registry is left: the port's registry is the JAX
    registry, every table of it included."""
    assert set(tmc.trainer_configs) == set(method_configs)
    for table in (tmc.model_configs, tmc.model_names, tmc.optimizer_configs,
                  tmc.camera_optimizer_configs, tmc.train_num_rays_per_batch,
                  tmc.descriptions):
        assert set(method_configs) <= set(table)
