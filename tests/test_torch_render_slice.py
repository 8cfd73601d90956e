"""The port's K-Planes eval render (soccernerfs_tpu_torch) against the JAX
package on the CPU, at a tiny config: F = 32, scales (1, 2), proposal
samples (24, 16) + 16 field samples, one 8x8 camera with a time.

Inputs are made with numpy from a seed; params come from the JAX package's
``kplanes.init`` through ``params_from_jax``.  Both packages gather bf16
plane tables and run bf16-operand MLPs with f32 products, so the remaining
differences are f32 reduction orders: every comparison is stated with its
tolerance.
"""
import ast
import dataclasses
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from soccernerfs_tpu.core import cameras as jcam
from soccernerfs_tpu.core import math as jmath
from soccernerfs_tpu.core import rays as jrays
from soccernerfs_tpu.fields import kplanes as jkpf
from soccernerfs_tpu.models import kplanes as jk
from soccernerfs_tpu.ops import mlp as jmlp
from soccernerfs_tpu.ops import rendering as jrend
from soccernerfs_tpu.ops import samplers as jsamp
from soccernerfs_tpu.ops import searching as jsearch
from soccernerfs_tpu_torch import convert
from soccernerfs_tpu_torch.configs.method_configs import model_configs
from soccernerfs_tpu_torch.core import cameras as tcam
from soccernerfs_tpu_torch.core import math as tmath
from soccernerfs_tpu_torch.core import rays as trays
from soccernerfs_tpu_torch.engine.render import render_camera
from soccernerfs_tpu_torch.fields import kplanes as tkpf
from soccernerfs_tpu_torch.models import kplanes as tk
from soccernerfs_tpu_torch.ops import mlp as tmlp
from soccernerfs_tpu_torch.ops import rendering as trend
from soccernerfs_tpu_torch.ops import samplers as tsamp
from soccernerfs_tpu_torch.ops import searching as tsearch
from soccernerfs_tpu_torch.utils.device import resolve_device


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


REPO = Path(__file__).resolve().parents[1]
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
)
AABB = np.array([[-1.5] * 3, [1.5] * 3], np.float32)
H = W = 8
KEYS = ("rgb", "accumulation", "depth", "median_rgb", "prop_depth_0",
        "prop_depth_1")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _camera_args():
    c2w = np.eye(3, 4, dtype=np.float32)[None]
    c2w[0, :, 3] = [0.2, -0.1, 3.0]          # outside the box, facing it
    return dict(camera_to_worlds=c2w, fx=7.0, fy=7.5, cx=4.1, cy=3.9,
                width=W, height=H, times=np.array([0.3], np.float32))


def _pixel_coords():
    yy, xx = np.meshgrid(np.arange(H) + 0.5, np.arange(W) + 0.5, indexing="ij")
    return np.stack([yy, xx], -1).reshape(-1, 2).astype(np.float32)


def _time_noise(tree, seed=3):
    """Time planes init to exactly 1 (a multiplicative identity); jitter
    them so that a wrong time-plane lookup changes the output."""
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


@pytest.fixture(scope="module")
def slice_setup():
    jcfg = jk.Config(**TINY)
    tcfg = tk.Config(**TINY)
    # jitted, as the JAX trainer runs them (op-by-op dispatch is ~5x slower)
    np_tree = _time_noise(jax.tree_util.tree_map(
        np.asarray, jax.jit(jk.init, static_argnums=1)(jax.random.PRNGKey(0),
                                                       jcfg)))
    jparams = jax.tree_util.tree_map(jnp.asarray, np_tree)
    tparams = convert.params_from_jax(np_tree, device=CPU)
    coords = _pixel_coords()
    idx = np.zeros(coords.shape[0], np.int32)
    jrb = jcam.generate_rays(jcam.Cameras.create(**_camera_args()),
                             jnp.asarray(idx), jnp.asarray(coords))

    @jax.jit
    def eval_forward(params, rb):
        out = jk.get_outputs(jcfg, jk.prepare_render_params(jcfg, params),
                             jnp.asarray(AABB), rb, train=False)
        return {k: out[k] for k in KEYS}

    jout = eval_forward(jparams, jrb)
    return dict(jcfg=jcfg, tcfg=tcfg, np_tree=np_tree, jparams=jparams,
                tparams=tparams, coords=coords, idx=idx, jrb=jrb,
                eval_forward=eval_forward,
                jout={k: np.asarray(jout[k]) for k in KEYS})


def _bundle(rb_j):
    """The port's RayBundle with the same rays as a JAX bundle."""
    return trays.RayBundle(
        origins=_t(rb_j.origins), directions=_t(rb_j.directions),
        pixel_area=_t(rb_j.pixel_area),
        camera_indices=None if rb_j.camera_indices is None else _t(rb_j.camera_indices),
        nears=None if rb_j.nears is None else _t(rb_j.nears),
        fars=None if rb_j.fars is None else _t(rb_j.fars),
        times=None if rb_j.times is None else _t(rb_j.times),
    )


def test_port_imports_no_jax():
    """The port and chip_smoke.py import neither JAX, flax nor any module
    of the JAX package."""
    files = sorted((REPO / "soccernerfs_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                root = n.split(".")[0]
                assert root not in ("jax", "jaxlib", "flax", "optax",
                                    "soccernerfs_tpu"), f"{f}: imports {n}"


def test_entry_points_need_cuda_unless_cpu_is_asked():
    """Entry points default to CUDA and raise without it; device='cpu'
    runs on the CPU."""
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        convert.params_from_jax({"w": np.zeros(2, np.float32)})


def test_seeded_params_match_jax_init_layout(slice_setup):
    """seeded_params (numpy, no JAX) builds the tree of JAX's
    kplanes.init: same structure, shapes and dtypes; time planes near 1,
    space planes in U(0.1, 0.5)."""
    tree = convert.seeded_params(slice_setup["tcfg"], 0, time_noise=0.05)
    ref = slice_setup["np_tree"]
    assert (jax.tree_util.tree_structure(tree)
            == jax.tree_util.tree_structure(ref))
    for a, b in zip(jax.tree_util.tree_leaves(tree),
                    jax.tree_util.tree_leaves(ref)):
        assert a.shape == b.shape and a.dtype == b.dtype
    grids = tree["fields"]["grids"][0]
    assert 0.1 <= grids[0].min() and grids[0].max() <= 0.5
    assert np.abs(grids[2] - 1.0).max() <= 0.05
    params = convert.params_from_jax(tree, device=CPU)
    assert params["fields"]["grids"][1][5].shape == (5, 16, 32)
    assert params["fields"]["sigma_net"]["w"][0].dtype == torch.float32


@pytest.mark.parametrize("linear_decoder", [False, True])
def test_port_init_matches_jax_init_layout(slice_setup, linear_decoder):
    """The port's own init (torch.Generator draws) builds the layout of
    JAX's kplanes.init: same tree, shapes and dtypes; time planes ones,
    space planes in U(0.1, 0.5), proposal planes in U(0.1, 0.15)."""
    jcfg = dataclasses.replace(slice_setup["jcfg"], linear_decoder=linear_decoder)
    tcfg = dataclasses.replace(slice_setup["tcfg"], linear_decoder=linear_decoder)
    ref = jax.eval_shape(lambda: jk.init(jax.random.PRNGKey(0), jcfg))
    got = tk.init(tcfg, generator=torch.Generator().manual_seed(0), device=CPU)
    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(ref))
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(ref)):
        assert tuple(a.shape) == b.shape and a.dtype == torch.float32
    grids = got["fields"]["grids"][1]
    assert 0.1 <= float(grids[0].min()) and float(grids[0].max()) <= 0.5
    assert bool((grids[2] == 1.0).all())
    prop = got["proposal_networks"]["proposal_0"]["grids"][0][0]
    assert 0.1 <= float(prop.min()) and float(prop.max()) <= 0.15


def test_model_config_copies_registered_kplanes():
    """The port's k-planes model config equals the JAX registry's."""
    from soccernerfs_tpu.configs.method_configs import method_configs

    ref = method_configs["k-planes"].pipeline.model
    got = model_configs["k-planes"]
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(ref, f.name), f.name


def test_math_matches_jax():
    """intersect_aabb, scene_contraction and the SH basis: elementwise f32
    arithmetic in the same order, 1e-6."""
    rng = np.random.default_rng(1)
    o = rng.uniform(-3, 3, (300, 3)).astype(np.float32)
    d = rng.standard_normal((300, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    jn, jf = jmath.intersect_aabb(jnp.asarray(o), jnp.asarray(d), jnp.asarray(AABB))
    tn, tf = tmath.intersect_aabb(_t(o), _t(d), _t(AABB))
    np.testing.assert_allclose(_np(tn), np.asarray(jn), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(_np(tf), np.asarray(jf), rtol=1e-6, atol=1e-6)
    for order in (None, math.inf):
        np.testing.assert_allclose(
            _np(tmath.scene_contraction(_t(o), order)),
            np.asarray(jmath.scene_contraction(
                jnp.asarray(o), jnp.inf if order else None)),
            atol=1e-6)
    for levels in (1, 2, 3, 4):
        np.testing.assert_allclose(
            _np(tmath.components_from_spherical_harmonics(levels, _t(d))),
            np.asarray(jmath.components_from_spherical_harmonics(
                levels, jnp.asarray(d))),
            atol=1e-6)


@pytest.mark.parametrize("distorted", [False, True])
def test_generate_rays_matches_jax(distorted):
    """Rays (origins, directions, pixel areas, norms, times), with and
    without the Newton undistortion: 1e-6 absolute (f32, same order)."""
    args = _camera_args()
    if distorted:
        args["distortion_params"] = np.array(
            [[0.05, -0.01, 0.002, 0.0, 0.001, -0.002]], np.float32)
    coords = _pixel_coords()
    idx = np.zeros(coords.shape[0], np.int32)
    jr = jcam.generate_rays(jcam.Cameras.create(**args), jnp.asarray(idx),
                            jnp.asarray(coords))
    tr = tcam.generate_rays(tcam.Cameras.create(**args, device=CPU), _t(idx),
                            _t(coords))
    for name in ("origins", "directions", "pixel_area", "directions_norm",
                 "times"):
        np.testing.assert_allclose(_np(getattr(tr, name)),
                                   np.asarray(getattr(jr, name)), atol=1e-6,
                                   err_msg=name)
    np.testing.assert_array_equal(
        _np(tcam.get_image_coords(3, 5)), np.asarray(jcam.get_image_coords(3, 5)))


def test_searchsorted_matches_jax():
    rng = np.random.default_rng(2)
    seq = np.sort(rng.uniform(0, 1, (20, 33)).astype(np.float32), axis=-1)
    seq[:, 5] = seq[:, 4]                          # ties
    vals = rng.uniform(-0.1, 1.1, (20, 17)).astype(np.float32)
    vals[:, 0] = seq[:, 4]                         # exact hits
    for side in ("left", "right"):
        np.testing.assert_array_equal(
            _np(tsearch.searchsorted(_t(seq), _t(vals), side)),
            np.asarray(jsearch.searchsorted(jnp.asarray(seq), jnp.asarray(vals), side)))
        np.testing.assert_array_equal(
            _np(tsearch.searchsorted_scalar(_t(seq), 0.5, side)),
            np.asarray(jsearch.searchsorted_scalar(jnp.asarray(seq), 0.5, side)))


def _spaced_pair(n=64, s=24, seed=4):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    nears = rng.uniform(0.0, 0.5, n).astype(np.float32)
    fars = (nears + rng.uniform(0.5, 3.0, n)).astype(np.float32)
    jrb = jrays.RayBundle(origins=jnp.asarray(o), directions=jnp.asarray(d),
                          pixel_area=jnp.ones(n), nears=jnp.asarray(nears),
                          fars=jnp.asarray(fars))
    trb = _bundle(jrb)
    return (jrb, jsamp.spaced_samples(jrb, s, spacing="uniform"),
            trb, tsamp.spaced_samples(trb, s, spacing="uniform"))


@pytest.mark.parametrize("weights_kind", ["random", "first", "last", "zero"])
@pytest.mark.parametrize("stratified", [False, True])
def test_pdf_samples_matches_jax(weights_kind, stratified):
    """pdf_samples (searchsorted + gather) == JAX's masked reductions,
    including the clipped-index fills: weight mass in the first or last
    bin, all-zero weights, and jittered u's up to just under 1 (the JAX
    draws, handed to the port).

    Tolerance: XLA's and torch's f32 cumsums round differently (up to
    ~4e-7 here).  Where the mass is spread, that moves a bin by ~1e-6, so
    1e-5.  Where one bin holds nearly all of it, each other bin carries
    ~2e-4 of the CDF, and inverting it magnifies the CDF's rounding by
    bin width / bin mass (1/24 / 2e-4 ~ 200): 2e-4 there."""
    jrb, jrs, trb, trs = _spaced_pair()
    rng = np.random.default_rng(5)
    n, s, q = 64, 24, 16
    w = rng.uniform(0, 1, (n, s)).astype(np.float32)
    if weights_kind == "first":
        w[:] = 0.0
        w[:, 0] = 50.0
    elif weights_kind == "last":
        w[:] = 0.0
        w[:, -1] = 50.0
    elif weights_kind == "zero":
        w[:] = 0.0
    key = jax.random.PRNGKey(7) if stratified else None
    jout = jsamp.pdf_samples(jrb, jrs, jnp.asarray(w), q, rng=key,
                             stratified=stratified, include_original=False)
    jitter = None
    if stratified:
        jitter = _t(jax.random.uniform(key, (n, q + 1)))
    tout = tsamp.pdf_samples(trb, trs, _t(w), q, jitter=jitter,
                             include_original=False)
    atol = 1e-5 if weights_kind in ("random", "zero") else 2e-4
    for name in ("spacing_starts", "spacing_ends", "starts", "ends"):
        np.testing.assert_allclose(_np(getattr(tout, name)),
                                   np.asarray(getattr(jout, name)), atol=atol,
                                   err_msg=name)
    jinc = jsamp.pdf_samples(jrb, jrs, jnp.asarray(w), q, include_original=True)
    tinc = tsamp.pdf_samples(trb, trs, _t(w), q, include_original=True)
    np.testing.assert_allclose(_np(tinc.starts), np.asarray(jinc.starts),
                               atol=atol)


def test_spaced_samples_jitter_matches_jax():
    """Stratified spaced samples with the JAX draws handed to the port."""
    jrb, _, trb, _ = _spaced_pair()
    key = jax.random.PRNGKey(9)
    jout = jsamp.spaced_samples(jrb, 24, spacing="piecewise", rng=key,
                                stratified=True)
    tout = tsamp.spaced_samples(trb, 24, spacing="piecewise",
                                jitter=_t(jax.random.uniform(key, (64, 25))))
    np.testing.assert_allclose(_np(tout.starts), np.asarray(jout.starts), atol=1e-5)
    np.testing.assert_allclose(_np(tout.ends), np.asarray(jout.ends), atol=1e-5)


def test_proposal_sample_matches_jax():
    """Eval proposal sampling with an analytic density on both sides:
    final samples and per-level weights at 1e-5."""
    jrb, _, trb, _ = _spaced_pair()

    def jdens(rs):
        p = rs.get_positions()
        return jnp.exp(2.0 * jnp.sin(3.0 * p[..., 0]) + p[..., 1])

    def tdens(rs):
        p = rs.get_positions()
        return torch.exp(2.0 * torch.sin(3.0 * p[..., 0]) + p[..., 1])

    js, jw, _ = jsamp.proposal_sample(jrb, [jdens, jdens], (24, 16), 12,
                                      initial_spacing="uniform")
    ts, tw, _ = tsamp.proposal_sample(trb, [tdens, tdens], (24, 16), 12,
                                      initial_spacing="uniform")
    np.testing.assert_allclose(_np(ts.starts), np.asarray(js.starts), atol=1e-5)
    np.testing.assert_allclose(_np(ts.ends), np.asarray(js.ends), atol=1e-5)
    for a, b in zip(tw, jw):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=1e-5)


def test_renderers_match_jax():
    """Compositing on random samples: sums in another order, 1e-6."""
    jrb, jrs, trb, trs = _spaced_pair()
    rng = np.random.default_rng(6)
    dens = rng.exponential(1.0, (64, 24)).astype(np.float32)
    rgb = rng.uniform(0, 1, (64, 24, 3)).astype(np.float32)
    jw = jrs.get_weights(jnp.asarray(dens))
    tw = trs.get_weights(_t(dens))
    np.testing.assert_allclose(_np(tw), np.asarray(jw), atol=1e-6)
    for bg in ("last_sample", "white", "black"):
        np.testing.assert_allclose(
            _np(trend.render_rgb(_t(rgb), tw, bg)),
            np.asarray(jrend.render_rgb(jnp.asarray(rgb), jw, bg, train=False)),
            atol=1e-6)
    np.testing.assert_allclose(_np(trend.render_accumulation(tw)),
                               np.asarray(jrend.render_accumulation(jw)), atol=1e-6)
    np.testing.assert_allclose(_np(trend.render_depth(tw, trs)),
                               np.asarray(jrend.render_depth(jw, jrs)), atol=1e-6)
    np.testing.assert_allclose(_np(trend.render_median_rgb(_t(rgb), tw)),
                               np.asarray(jrend.render_median_rgb(jnp.asarray(rgb), jw)),
                               atol=1e-6)


def test_mlp_matches_jax():
    """bf16 operands, f32 products: the policy of JAX's mlp_apply.

    The products are exact and only their f32 sums run in another order,
    so 99 % of outputs agree to 1e-5.  A hidden activation whose sum lands
    on a bf16 rounding boundary rounds the other way in one package, which
    moves the outputs it feeds by up to about |w| * 2^-8 * |h|: 1e-3
    bounds every output."""
    rng = np.random.default_rng(8)
    params = jax.tree_util.tree_map(
        np.asarray, jmlp.init_mlp(jax.random.PRNGKey(1), 40, 64, 2, 7))
    x = rng.standard_normal((500, 40)).astype(np.float32)
    want = np.asarray(jmlp.mlp_apply(jax.tree_util.tree_map(jnp.asarray, params),
                                     jnp.asarray(x), output_activation="sigmoid"))
    got = _np(tmlp.mlp_apply(convert.params_from_jax(params, device=CPU), _t(x),
                             output_activation="sigmoid"))
    assert np.mean(np.abs(got - want) > 1e-5) < 0.01
    np.testing.assert_allclose(got, want, atol=1e-3)


@pytest.mark.parametrize("staged", ["none", "packed", "unpacked"])
def test_field_forward_matches_jax(slice_setup, staged):
    """kplanes_field_forward (density, rgb) at random points with times,
    without staging, staged by pack_grids_for_render (quad-packed at this
    size), and with every table staged unpacked (the unpacked sampler):
    the JAX unsorted path ignores staged tables but gathers the same bf16
    values.  1e-5 relative."""
    rng = np.random.default_rng(9)
    m = 400
    pos = rng.uniform(-1.6, 1.6, (m, 3)).astype(np.float32)
    dirs = rng.standard_normal((m, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    times = rng.uniform(0, 1, m).astype(np.float32)
    fcfg_j = slice_setup["jcfg"].field_config()
    fcfg_t = slice_setup["tcfg"].field_config()
    jd, jc = jkpf.kplanes_field_forward(
        fcfg_j, slice_setup["jparams"]["fields"], jnp.asarray(AABB),
        jnp.asarray(pos), jnp.asarray(dirs), jnp.asarray(times), train=False)
    tparams = slice_setup["tparams"]["fields"]
    if staged == "packed":
        tparams = tkpf.pack_grids_for_render(tparams)
    elif staged == "unpacked":
        tparams = {**tparams, "grids_packed": [
            [g.reshape(-1, g.shape[-1]).to(torch.bfloat16) for g in gs]
            for gs in tparams["grids"]]}
    td, tc = tkpf.kplanes_field_forward(fcfg_t, tparams, _t(AABB), _t(pos),
                                        _t(dirs), _t(times))
    np.testing.assert_allclose(_np(td), np.asarray(jd), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(tc), np.asarray(jc), atol=1e-5)


def test_get_outputs_matches_jax(slice_setup):
    """get_outputs(train=False) on the camera's 64 rays: rgb,
    accumulation, depths and median rgb at 1e-5 absolute (f32 reduction
    orders through two proposal levels; depth in scene units ~2.5)."""
    tcfg = slice_setup["tcfg"]
    tparams = tk.prepare_render_params(tcfg, slice_setup["tparams"])
    tout = tk.get_outputs(tcfg, tparams, _t(AABB), _bundle(slice_setup["jrb"]))
    for k in KEYS:
        np.testing.assert_allclose(_np(tout[k]), slice_setup["jout"][k],
                                   atol=1e-5, err_msg=k)
    assert float(tout["accumulation"].min()) > 0.05   # rays hit the planes


@pytest.mark.parametrize("chunk", [24, 64])
def test_render_camera_matches_jax(slice_setup, chunk):
    """render_camera (chunked, zero-padded tail when 64 % chunk != 0,
    staged once) == a JAX render of the same frame chunked the way
    Trainer.render_camera chunks it (zero-coordinate padding rays), on
    rgb, depth and accumulation, [H, W, ...]; 1e-5 as get_outputs."""
    tcfg = slice_setup["tcfg"]
    cams = tcam.Cameras.create(**_camera_args(), device=CPU)
    out = render_camera(tcfg, slice_setup["tparams"], cams, 0, chunk=chunk,
                        device=CPU, aabb=AABB)
    assert set(out) == {"rgb", "depth", "accumulation"}

    n = H * W
    n_pad = -(-n // chunk) * chunk
    coords = np.concatenate([slice_setup["coords"],
                             np.zeros((n_pad - n, 2), np.float32)])
    jcams = jcam.Cameras.create(**_camera_args())
    chunks = []
    for i in range(0, n_pad, chunk):
        rb = jcam.generate_rays(jcams, jnp.zeros(chunk, jnp.int32),
                                jnp.asarray(coords[i:i + chunk]))
        chunks.append(slice_setup["eval_forward"](slice_setup["jparams"], rb))
    for k, shape in (("rgb", (H, W, 3)), ("depth", (H, W)),
                     ("accumulation", (H, W))):
        want = np.concatenate([np.asarray(c[k]) for c in chunks])[:n]
        np.testing.assert_allclose(_np(out[k]), want.reshape(shape),
                                   atol=1e-5, err_msg=k)


def test_render_camera_refuses_params_on_another_device(slice_setup):
    cams = tcam.Cameras.create(**_camera_args(), device=CPU)
    meta = jax.tree_util.tree_map(lambda x: x.to("meta"), slice_setup["tparams"])
    with pytest.raises(ValueError, match="params are on"):
        render_camera(slice_setup["tcfg"], meta, cams, 0, device=CPU, aabb=AABB)
