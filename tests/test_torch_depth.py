"""Depth supervision in the port (soccernerfs_tpu_torch) against the JAX
package on the CPU: the DS-NeRF and URF depth losses and their gradients,
the decaying sigma, the depth-map reader, the nerfstudio-format parser
field by field, the datamanager's depth batches, one whole train step of
k-planes and of depth-nerfacto on a batch with target depths (loss terms
and every gradient leaf against ``jax.value_and_grad``), and depth-nerfacto
through ``snt-train``, ``snt-eval`` and ``snt-render`` on a nerfstudio
scene with depth maps.

Inputs are made with numpy from a seed; torch cannot reproduce JAX's PRNG
streams, so the steps take JAX's own draws.  Every tolerance is stated
with its reason.
"""
import dataclasses
import functools
import json
import random
import warnings

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from soccernerfs_tpu.configs.method_configs import method_configs as jax_registry
from soccernerfs_tpu.core import camera_optimizer as jco
from soccernerfs_tpu.core import cameras as jcam
from soccernerfs_tpu.core import rays as jrays
from soccernerfs_tpu.data import datasets as jds
from soccernerfs_tpu.data import fixtures as jfix
from soccernerfs_tpu.data import native_loader
from soccernerfs_tpu.data.datamanager import DynamicDataManagerConfig as JDMConfig
from soccernerfs_tpu.data.dataparsers.nerfstudio_parser import (
    NerfstudioDataParserConfig as JNerfstudio,
)
from soccernerfs_tpu.data.dataparsers.soccer import (
    BroadcaststyleDataParserConfig as JBroadcast,
)
from soccernerfs_tpu.models import depth_nerfacto as jdn
from soccernerfs_tpu.models import kplanes as jk
from soccernerfs_tpu.ops import losses as jL
from soccernerfs_tpu_torch import convert
from soccernerfs_tpu_torch.configs import method_configs as tmc
from soccernerfs_tpu_torch.core import camera_optimizer as tco
from soccernerfs_tpu_torch.core import cameras as tcam
from soccernerfs_tpu_torch.core import rays as trays
from soccernerfs_tpu_torch.data import datasets as tds
from soccernerfs_tpu_torch.data import fixtures as tfix
from soccernerfs_tpu_torch.data.datamanager import DynamicDataManagerConfig as TDMConfig
from soccernerfs_tpu_torch.data.dataparsers import DATAPARSERS
from soccernerfs_tpu_torch.data.dataparsers.soccer import (
    BroadcaststyleDataParserConfig as TBroadcast,
)
from soccernerfs_tpu_torch.engine.trainer import TrainStep
from soccernerfs_tpu_torch.models import depth_nerfacto as tdn
from soccernerfs_tpu_torch.models import get_model
from soccernerfs_tpu_torch.models import kplanes as tk
from soccernerfs_tpu_torch.ops import losses as tL
from soccernerfs_tpu_torch.scripts import eval as eval_script
from soccernerfs_tpu_torch.scripts import render as render_script
from soccernerfs_tpu_torch.scripts import train as train_script

TNerfstudio = DATAPARSERS["nerfstudio-data"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch CPU thread while this file runs (the suite runs in
    parallel worker processes, whose default thread pools oversubscribe
    the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _no_native_loader(monkeypatch):
    """JAX's pixel sampler and cache use its C++ loader when it loads; the
    port draws and decodes with numpy, JAX's path without it."""
    monkeypatch.setattr(native_loader, "available", lambda: False)


CPU = "cpu"
AABB = np.array([[-1.5] * 3, [1.5] * 3], np.float32)
H = W = 8
N_RAYS = 96
N_CAMS = 3


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return None if x is None else np.asarray(x)


def _rel(got, want) -> float:
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


def _l2(got, want) -> float:
    got, want = _np(got), _np(want)
    return float(np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-30))


def _targets(rng, n, lo=2.0, hi=4.0, zeros=0.1):
    """Target depths U(lo, hi), a share ``zeros`` of them 0 (no target)."""
    depth = rng.uniform(lo, hi, n).astype(np.float32)
    depth[rng.uniform(0, 1, n) < zeros] = 0.0
    return depth


# ---------------------------------------------------------------------------
# the losses and the sigma schedule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("euclidean", [True, False], ids=["euclidean", "z"])
@pytest.mark.parametrize("kind", ["ds_nerf", "urf"])
def test_depth_loss_matches_jax(kind, euclidean):
    """``depth_loss`` on 64 rays of 24 sorted samples in [1, 5], weights a
    softmax of random logits, targets in [2, 4] with ~10 % zeros (masked),
    directions norms in [1, 1.3], sigma 0.05: the value and its gradient
    with respect to the weights (and, for URF, the predicted depth) equal
    JAX's within 1e-5 relative (f32 sums in another order)."""
    rng = np.random.default_rng(3)
    n, s = 64, 24
    edges = np.sort(rng.uniform(1.0, 5.0, (n, s + 1)), axis=-1).astype(np.float32)
    logits = rng.normal(0, 2, (n, s)).astype(np.float32)
    weights = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).astype(np.float32)
    target = _targets(rng, n)
    predicted = rng.uniform(2, 4, n).astype(np.float32)
    norms = rng.uniform(1.0, 1.3, n).astype(np.float32)
    sigma = np.float32(0.05)
    common = dict(origins=np.zeros((n, 3), np.float32),
                  directions=np.tile(np.array([[0, 0, 1]], np.float32), (n, 1)),
                  pixel_area=np.ones(n, np.float32), starts=edges[:, :-1],
                  ends=edges[:, 1:], spacing_starts=edges[:, :-1],
                  spacing_ends=edges[:, 1:], s_near=np.zeros(n, np.float32),
                  s_far=np.ones(n, np.float32))
    jrs = jrays.RaySamples(**{k: jnp.asarray(v) for k, v in common.items()})
    trs = trays.RaySamples(**{k: _t(v) for k, v in common.items()})

    def jloss(w, p):
        return jL.depth_loss(w, jrs, jnp.asarray(target), p, sigma,
                             jnp.asarray(norms), euclidean, kind)

    jvalue, (jgw, jgp) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(weights), jnp.asarray(predicted))
    w, p = _t(weights).requires_grad_(True), _t(predicted).requires_grad_(True)
    value = tL.depth_loss(w, trs, _t(target), p, torch.tensor(sigma), _t(norms),
                          euclidean, kind)
    gw, gp = torch.autograd.grad(value, (w, p), allow_unused=True)
    assert float(value.detach()) > 0.0
    assert _rel(value, jvalue) <= 1e-5
    assert _rel(gw, jgw) <= 1e-5
    # the rays without a target get no gradient
    assert float(gw[target == 0].abs().max()) == 0.0
    if kind == "urf":
        assert _rel(gp, jgp) <= 1e-5
    else:
        assert gp is None and float(jnp.abs(jgp).max()) == 0.0
    with pytest.raises(NotImplementedError):
        tL.depth_loss(w, trs, _t(target), p, torch.tensor(sigma), _t(norms),
                      euclidean, "no-such-loss")


def test_depth_sigma_for_step_matches_jax():
    """The decaying sigma, 0.2 * 0.99985 ** step floored at 0.01, over steps
    0-30,000: the port's value is the exact one from the f32-rounded
    constants, rounded to f32; JAX's f32 power of an int32 step drifts from
    it by up to ~1.7e-4 relative at step 30,000, so the two are held within
    2e-4.  Without decay, both are depth_sigma."""
    cfg = tdn.Config()
    jcfg = jdn.Config()
    steps = np.arange(0, 30_001, 7)
    want = np.asarray(jax.jit(jax.vmap(
        lambda st: jk.depth_sigma_for_step(jcfg, st)))(jnp.asarray(steps, jnp.int32)))
    got = np.array([tk.depth_sigma_for_step(cfg, int(st)) for st in steps])
    assert np.all(np.abs(got - want) / want <= 2e-4)
    assert np.all(got[:-1] >= got[1:]) and got[-1] == np.float32(0.01)
    f32 = np.float32
    exact = np.maximum(float(f32(0.2)) * float(f32(0.99985)) ** steps.astype(np.float64),
                       float(f32(0.01))).astype(np.float32)
    np.testing.assert_array_equal(got.astype(np.float32), exact)
    plain = tk.Config()
    assert tk.depth_sigma_for_step(plain, 500) == float(
        jk.depth_sigma_for_step(jk.Config(), 500)) == float(f32(0.01))


# ---------------------------------------------------------------------------
# depth maps on disk
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["npy", "png16", "tiff_mode_i"])
def test_depth_image_from_path_matches_jax(tmp_path, kind):
    """A 12 x 20 depth map read at 9 x 14 (nearest) and at its own size,
    scaled by 1e-3: a float64 .npy, a 16-bit PNG and a 32-bit mode-I TIFF
    (values past 16 bits) give JAX's arrays exactly."""
    rng = np.random.default_rng(4)
    if kind == "npy":
        path = tmp_path / "d.npy"
        np.save(path, rng.uniform(0, 5000, (12, 20)))
    elif kind == "png16":
        path = tmp_path / "d.png"
        Image.fromarray(rng.integers(0, 65536, (12, 20)).astype(np.uint16)).save(path)
    else:
        path = tmp_path / "d.tiff"
        Image.fromarray(rng.integers(0, 1 << 20, (12, 20)).astype(np.int32)).save(path)
    for h, w in ((9, 14), (12, 20)):
        got = tds.get_depth_image_from_path(path, h, w, 1e-3)
        want = jds.get_depth_image_from_path(path, h, w, 1e-3)
        assert got.dtype == np.float32 and got.shape == (h, w)
        np.testing.assert_array_equal(got, want)
        assert float(got.max()) > 0


# ---------------------------------------------------------------------------
# the nerfstudio-format parser
# ---------------------------------------------------------------------------

def _nerfstudio_scene(root, variant):
    """A written nerfstudio scene of 12 frames at 24 x 32 in one of the
    parser's layouts."""
    downscale = 2 if variant == "masks_depths_downscale_2" else 1
    data = tfix.make_nerfstudio_fixture(root, num_frames=12, h=24, w=32,
                                        downscale=downscale)
    meta = json.loads((data / "transforms.json").read_text())
    if variant == "per_frame":
        # per-frame intrinsics and distortion, an orientation override, and
        # a frame whose image is missing (skipped)
        for i, frame in enumerate(meta["frames"]):
            for key in ("fl_x", "fl_y", "cx", "cy", "h", "w"):
                frame[key] = meta[key] + (i % 3 if key not in ("h", "w") else 0)
            frame["k1"], frame["p2"] = 0.01 * i, -0.002 * i
        for key in ("fl_x", "fl_y", "cx", "cy", "h", "w", "k1", "k2", "p1", "p2"):
            del meta[key]
        meta["orientation_override"] = "none"
        (data / "images" / "frame_00004.png").unlink()
    elif variant == "distortion":
        meta.update(k1=0.05, k2=-0.01, p1=0.001, camera_model="OPENCV")
    elif variant == "masks_depths_downscale_2":
        (data / "masks_2").mkdir()
        rng = np.random.default_rng(5)
        for frame in meta["frames"]:
            name = frame["file_path"].split("/")[-1]
            Image.fromarray((rng.uniform(0, 1, (24, 32)) < 0.7).astype(np.uint8)
                            * 255).save(data / "masks_2" / name)
            frame["mask_path"] = f"masks/{name}"
    (data / "transforms.json").write_text(json.dumps(meta))
    return data


@pytest.mark.parametrize("split", ["train", "val"])
@pytest.mark.parametrize("variant", ["global", "per_frame", "distortion",
                                     "masks_depths_downscale_2"])
def test_nerfstudio_parser_matches_jax(tmp_path, variant, split):
    """File names (images, masks, depths), intrinsics, distortion, sizes,
    camera type, poses (1e-6), scene box, the dataparser's scale and
    transform, the fraction split, no times; the registry's defaults."""
    data = _nerfstudio_scene(tmp_path / "ns", variant)
    ds = 2 if variant == "masks_depths_downscale_2" else None
    j = JNerfstudio(data=data, downscale_factor=ds).setup().get_dataparser_outputs(split)
    t = TNerfstudio(data=data, downscale_factor=ds).setup().get_dataparser_outputs(split)
    assert t.image_filenames == j.image_filenames and len(t.image_filenames) > 0
    assert t.mask_filenames == j.mask_filenames
    assert (t.mask_filenames is not None) == (variant == "masks_depths_downscale_2")
    assert t.metadata == j.metadata
    assert all(p.is_file() for p in t.metadata["depth_filenames"])
    jc, tc = j.cameras, t.cameras
    for name in ("fx", "fy", "cx", "cy", "width", "height", "distortion_params",
                 "camera_type"):
        np.testing.assert_array_equal(_np(getattr(tc, name)),
                                      np.asarray(getattr(jc, name)), err_msg=name)
    assert tc.times is None and jc.times is None
    np.testing.assert_allclose(_np(tc.camera_to_worlds),
                               np.asarray(jc.camera_to_worlds), atol=1e-6)
    np.testing.assert_array_equal(_np(t.scene_box.aabb), np.asarray(j.scene_box.aabb))
    assert t.dataparser_scale == pytest.approx(j.dataparser_scale, rel=1e-12)
    np.testing.assert_allclose(np.asarray(t.dataparser_transform),
                               np.asarray(j.dataparser_transform), atol=1e-7)
    assert ([(f.name, f.default) for f in dataclasses.fields(TNerfstudio)]
            == [(f.name, f.default) for f in dataclasses.fields(JNerfstudio)])


def test_nerfstudio_fixture_depths_are_z_depths(tmp_path):
    """The fixture's depth maps: millimetres of the analytic hit along the
    optical axis (0 where the ray hits nothing, the sky at the top of each
    image), read back through the dataset in the parser's scaled units."""
    data = tfix.make_nerfstudio_fixture(tmp_path / "ns", num_frames=10, h=24, w=32)
    outputs = TNerfstudio(data=data).setup().get_dataparser_outputs("train")
    dataset = tds.DynamicDataset(outputs, device=CPU)
    item = dataset[0]
    depth, image = item["depth_image"], item["image"]
    assert depth.shape == (24, 32) and image.shape == (24, 32, 3)
    sky = np.all(image == 0, axis=-1)
    assert sky[0].all() and not sky[-1].any()
    assert np.all((depth == 0) == sky)
    # the floor below the centre of the image: its distance along the axis
    # of a camera 2.5 out at height 0.5, in the parser's scale
    mm = np.asarray(Image.open(data / "depths" / "frame_00000.png"))
    assert np.allclose(depth, mm * 1e-3 * outputs.dataparser_scale, rtol=1e-6)
    centre = mm[12, 16] * 1e-3
    assert 2.0 < centre < 3.0


# ---------------------------------------------------------------------------
# the datamanager
# ---------------------------------------------------------------------------

def _assert_same_batches(j, t, steps):
    for step in range(steps):
        for name in ("next_train_raw", "next_eval_raw"):
            a, b = getattr(j, name)(step), getattr(t, name)(step)
            assert a.keys() == b.keys() and "depth_image" in a, name
            for k in a:
                np.testing.assert_array_equal(b[k], a[k], err_msg=f"{name} {k}")
    idx, _rays, data = t.next_eval_image(1)
    jidx, _jrays, jdata = j.next_eval_image(1)
    assert idx == jidx and data.keys() == jdata.keys()
    np.testing.assert_array_equal(data["depth_image"], jdata["depth_image"])


def test_datamanager_depth_batches_match_jax_nerfstudio(tmp_path):
    """depth-nerfacto's datamanager (importance sampling off, every image
    cached) on a nerfstudio scene with depth maps: train and eval batches
    carry the same target depths as JAX's at the same seeds; the cameras
    have no times."""
    data = tfix.make_nerfstudio_fixture(tmp_path / "ns", num_frames=10, h=24, w=32)
    common = dict(train_num_rays_per_batch=64, eval_num_rays_per_batch=32,
                  use_importance_sampling=False)
    random.seed(5)
    j = JDMConfig(dataparser=JNerfstudio(data=data), **common).setup(seed=5)
    t = TDMConfig(dataparser=TNerfstudio(data=data), **common).setup(
        seed=5, device=CPU)
    assert t.train_cameras.times is None
    _assert_same_batches(j, t, 4)


def test_datamanager_depth_batches_match_jax_broadcaststyle(tmp_path):
    """k-planes' datamanager (IST on, the cache refreshing) on the
    broadcaststyle fixture with depth maps read through
    ``depth_maps="depth-maps"`` (the masked variant's files)."""
    root = jfix.make_broadcaststyle_fixture(tmp_path / "b", num_cameras=4,
                                            num_steps=4, with_depth=True)
    common = dict(train_num_rays_per_batch=64, eval_num_rays_per_batch=32,
                  train_num_images_to_sample_from=6,
                  train_num_times_to_repeat_images=2,
                  eval_num_images_to_sample_from=2,
                  eval_num_times_to_repeat_images=1, use_importance_sampling=True,
                  iters_to_start_is=2, ist_range=1.0)
    parser = dict(data=root, fps_downsample=1.0, depth_maps="depth-maps")
    random.seed(5)
    j = JDMConfig(dataparser=JBroadcast(**parser), **common).setup(seed=5)
    t = TDMConfig(dataparser=TBroadcast(**parser), **common).setup(
        seed=5, device=CPU)
    assert all("depth-maps-mask" in str(p)
               for p in t.train_dataset.depth_filenames)
    _assert_same_batches(j, t, 6)


# ---------------------------------------------------------------------------
# one whole train step with target depths
# ---------------------------------------------------------------------------

def _camera_args(times=True):
    c2w = np.tile(np.eye(3, 4, dtype=np.float32)[None], (N_CAMS, 1, 1))
    c2w[:, :, 3] = [[0.2, -0.1, 3.0], [-0.3, 0.2, 2.8], [0.0, 0.1, 3.2]]
    args = dict(camera_to_worlds=c2w, fx=7.0, fy=7.5, cx=4.1, cy=3.9,
                width=W, height=H)
    if times:
        args["times"] = np.array([0.1, 0.5, 0.9], np.float32)
    return args


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {
        "cam_idx": rng.integers(0, N_CAMS, N_RAYS).astype(np.int32),
        "coords": rng.uniform(0, H, (N_RAYS, 2)).astype(np.float32),
        "image": rng.uniform(0, 1, (N_RAYS, 3)).astype(np.float32),
        # the cameras sit ~3 in front of the box's centre
        "depth_image": _targets(rng, N_RAYS, 2.0, 4.0),
    }


def _walk(tree, fn, path=()):
    if isinstance(tree, dict):
        return {k: _walk(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_walk(v, fn, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def _assert_step_matches(state, loss, ld, met, grads, jloss, jld, jmet, jgrads):
    """Loss terms and metrics within 1e-4 relative; every gradient leaf
    within 1e-2 in L2 (card-free, but the same bf16 MLP policy: a flipped
    rounding moves single elements, so leaves are held in L2)."""
    assert "depth_loss" in ld and "depth_loss" in met and set(jld) == set(ld)
    assert set(jmet) == set(met)
    assert float(ld["depth_loss"]) > 0.0
    assert _rel(loss, jloss) <= 1e-4
    for k in jld:
        assert _rel(ld[k], jld[k]) <= 1e-4, k
    for k in jmet:
        assert _rel(met[k], jmet[k]) <= 1e-4, k
    names = []
    _walk(state.params, lambda path, x: names.append(path))
    tgrads = dict(zip(names, grads))
    jflat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert len(jflat) == len(names)
    for path, jg in jflat:
        name = tuple(p.key if hasattr(p, "key") else p.idx for p in path)
        g = tgrads[name]
        assert g is not None and tuple(g.shape) == jg.shape, name
        assert _l2(g, jg) <= 1e-2, (name, _l2(g, jg))


KPLANES_TINY = dict(
    spacetime_resolution=(8, 8, 8, 5), feature_dim=32, multiscale_res=(1, 2),
    proposal_net_args_list=(
        {"feature_dim": 8, "resolution": (8, 8, 8, 5)},
        {"feature_dim": 8, "resolution": (16, 16, 16, 5)},
    ),
    num_proposal_samples_per_ray=(24, 16), num_nerf_samples_per_ray=16,
    sigma_net_hidden_dim=32, rgb_net_hidden_dim=32,
    disable_viewing_dependent=True,
)


@pytest.mark.parametrize("kind, euclidean", [("ds_nerf", False), ("urf", True)],
                         ids=["ds_nerf-z", "urf-euclidean"])
def test_kplanes_step_with_depth_matches_jax(kind, euclidean):
    """A k-planes step at step 300 (proposal update on) with the registry's
    loss coefficients (depth_loss 0.05) on a batch with target depths: the
    depth loss over the three levels' weights (ds_nerf against z-depths, as
    registered, and urf against euclidean ones, sigma decaying), every
    other term, PSNR, and every gradient before the update, against
    jax.value_and_grad with the same params, batch and draws."""
    extra = dict(KPLANES_TINY, is_euclidean_depth=euclidean,
                 depth_loss_type=kind, should_decay_sigma=kind == "urf")
    jcfg = jk.Config(**extra, loss_coefficients=tmc._KPLANES_LOSS_COEF)
    tcfg = tk.Config(**extra, loss_coefficients=dict(tmc._KPLANES_LOSS_COEF))
    rng = np.random.default_rng(3)

    def noise(path, x):
        # time planes init to exactly 1: jitter them
        x = np.asarray(x)
        if x.ndim == 3 and np.all(x == 1.0):
            return (x + rng.uniform(-0.2, 0.2, x.shape)).astype(np.float32)
        return x

    np_tree = _walk(jax.tree_util.tree_map(
        np.asarray, jax.jit(jk.init, static_argnums=1)(jax.random.PRNGKey(0), jcfg)),
        noise)
    jcams = jcam.Cameras.create(**_camera_args())
    step, key = 300, jax.random.PRNGKey(11)
    batch = _batch(0)

    def loss_fn(p):
        rays = jcam.generate_rays(jcams, batch["cam_idx"], batch["coords"])
        outputs = jk.get_outputs(jcfg, p, jnp.asarray(AABB), rays, rng=key,
                                 train=True, anneal=jk.proposal_anneal(jcfg, step),
                                 train_proposal_networks=True)
        metrics = jk.get_metrics_dict(jcfg, outputs, batch, step)
        ld = jk.get_loss_dict(jcfg, p, outputs, batch, metrics, train=True)
        return functools.reduce(jnp.add, ld.values()), (ld, metrics)

    (jloss, (jld, jmet)), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(jax.tree_util.tree_map(jnp.asarray, np_tree))

    rng_sample, rng_bg = jax.random.split(key)
    keys = jax.random.split(rng_sample, jcfg.num_proposal_iterations + 1)
    counts = [*jcfg.num_proposal_samples_per_ray, jcfg.num_nerf_samples_per_ray]
    jitters = [_t(jax.random.uniform(k, (N_RAYS, s + 1)))
               for k, s in zip(keys, counts)]
    trainer = TrainStep(tcfg, tcam.Cameras.create(**_camera_args(), device=CPU),
                        AABB, tmc.optimizer_configs["k-planes"], device=CPU)
    state = trainer.init_state(convert.params_from_jax(np_tree, device=CPU))
    state.step = step
    loss, ld, met, grads = trainer.loss_and_grads(
        state, {k: _t(v) for k, v in batch.items()}, train_proposal_networks=True,
        jitters=jitters, background=_t(jax.random.uniform(rng_bg, (N_RAYS, 3))))
    assert list(ld)[-1] == "depth_loss"
    _assert_step_matches(state, loss, ld, met, grads, jloss, jld, jmet, jgrads)


NERFACTO_SMALL = dict(
    num_levels=3, max_res=64, log2_hashmap_size=13, hidden_dim=16,
    hidden_dim_color=16, num_proposal_samples_per_ray=(12, 8),
    num_nerf_samples_per_ray=6,
    proposal_net_args_list=(
        {"hidden_dim": 8, "log2_hashmap_size": 12, "num_levels": 3, "max_res": 32},
        {"hidden_dim": 8, "log2_hashmap_size": 12, "num_levels": 3, "max_res": 64},
    ),
    eval_num_rays_per_chunk=64,
)


@pytest.mark.parametrize("kind", ["ds_nerf", "urf"])
def test_depth_nerfacto_step_matches_jax(kind):
    """A depth-nerfacto step at step 300 (sigma decayed to 0.2 * 0.99985^300)
    with the SO3xR3 camera optimizer on and non-zero pose adjustments, on
    cameras without times and a batch with z-depth targets (times the rays'
    direction norms): rgb, interlevel, distortion and the depth loss times
    depth_loss_mult, and every gradient (pose adjustments included), against
    jax.value_and_grad with the same params, batch and draws."""
    jcfg = jdn.Config(**NERFACTO_SMALL, depth_loss_type=kind)
    tcfg = tdn.Config(**NERFACTO_SMALL, depth_loss_type=kind)
    rng = np.random.default_rng(7)

    def lift(path, x):
        # the init's tables are U(-1e-4, 1e-4): scale them to +-0.3 so the
        # encoding shapes densities and gradients
        x = np.asarray(x)
        return x * 3000.0 if path[-1] == "embeddings" else x

    np_tree = _walk(jax.tree_util.tree_map(
        np.asarray, jdn.init(jax.random.PRNGKey(0), jcfg, N_CAMS)), lift)
    np_tree["camera_opt"] = {"pose_adjustment": (
        rng.standard_normal((N_CAMS, 6)) * 0.02).astype(np.float32)}
    jcams = jcam.Cameras.create(**_camera_args(times=False))
    jcam_cfg = jco.CameraOptimizerConfig(mode="SO3xR3")
    step, key = 300, jax.random.PRNGKey(11)
    batch = _batch(1)

    def loss_fn(p):
        cam_opt = jco.apply_camera_optimizer(jcam_cfg, p["camera_opt"],
                                             batch["cam_idx"])
        rays = jcam.generate_rays(jcams, batch["cam_idx"], batch["coords"], cam_opt)
        outputs = jdn.get_outputs(jcfg, p, jnp.asarray(AABB), rays, rng=key,
                                  train=True, anneal=jk.proposal_anneal(jcfg, step),
                                  train_proposal_networks=True)
        metrics = jdn.get_metrics_dict(jcfg, outputs, batch, step)
        ld = jdn.get_loss_dict(jcfg, p, outputs, batch, metrics, train=True)
        return functools.reduce(jnp.add, ld.values()), (ld, metrics)

    (jloss, (jld, jmet)), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(jax.tree_util.tree_map(jnp.asarray, np_tree))

    rng_sample, _ = jax.random.split(key)
    keys = jax.random.split(rng_sample, jcfg.num_proposal_iterations + 1)
    jitters = [_t(jax.random.uniform(k, (N_RAYS, 1))) for k in keys]
    trainer = TrainStep(
        tcfg, tcam.Cameras.create(**_camera_args(times=False), device=CPU), AABB,
        tmc.optimizer_configs["depth-nerfacto"], device=CPU,
        model="depth_nerfacto",
        camera_optimizer=tco.CameraOptimizerConfig(mode="SO3xR3"))
    state = trainer.init_state(convert.params_from_jax(np_tree, device=CPU))
    state.step = step
    loss, ld, met, grads = trainer.loss_and_grads(
        state, {k: _t(v) for k, v in batch.items()}, train_proposal_networks=True,
        jitters=jitters)
    assert list(ld) == ["rgb_loss", "interlevel_loss", "distortion_loss",
                        "depth_loss"]
    _assert_step_matches(state, loss, ld, met, grads, jloss, jld, jmet, jgrads)


def test_depth_nerfacto_registry_copy():
    """The port's depth-nerfacto: JAX's model config, optimizers, camera
    optimizer, datamanager (nerfstudio-data, importance sampling off) and
    vis; its params are nerfacto's (``seeded_params``), and the model
    module is registered."""
    port, jcfg = tmc.trainer_configs["depth-nerfacto"], jax_registry["depth-nerfacto"]
    assert (dataclasses.asdict(port.pipeline.model)
            == dataclasses.asdict(jcfg.pipeline.model))
    assert port.vis == jcfg.vis == "viewer"
    dm, jdm = port.pipeline.datamanager, jcfg.pipeline.datamanager
    assert type(dm.dataparser).__name__ == type(jdm.dataparser).__name__
    assert not dm.use_importance_sampling and dm.camera_optimizer.mode == "SO3xR3"
    assert get_model("depth_nerfacto") is tdn
    assert "depth-nerfacto" in tmc.trainer_configs
    small = tdn.Config(**NERFACTO_SMALL)
    tree = convert.seeded_params(small, 0, N_CAMS)
    jtree = jdn.init(jax.random.PRNGKey(0), jdn.Config(**NERFACTO_SMALL), N_CAMS)
    assert (jax.tree_util.tree_structure(jax.tree_util.tree_map(np.asarray, jtree))
            == jax.tree_util.tree_structure(tree))


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------

def test_depth_nerfacto_train_eval_render(tmp_path, monkeypatch):
    """A narrow depth-nerfacto through snt-train (its registered live
    viewer on a free port, answering /scene while the trainer lives; the
    logged depth loss finite and positive at every step), snt-eval (finite
    psnr and ssim) and snt-render (a spiral of PNG frames) on a nerfstudio
    scene with depth maps."""
    import urllib.request

    from soccernerfs_tpu_torch.utils import writer

    data = tfix.make_nerfstudio_fixture(tmp_path / "ns", num_frames=10, h=24, w=32)
    out = tmp_path / "out"

    class Events(writer.Writer):
        def __init__(self):
            self.scalars = []

        def write_scalar(self, name, scalar, step):
            self.scalars.append((name, step, scalar))

    sink = Events()
    setup_writers = writer.setup_writers

    def with_sink(*args, **kwargs):
        setup_writers(*args, **kwargs)
        writer._SINKS.append(sink)

    monkeypatch.setattr(writer, "setup_writers", with_sink)
    trainer = train_script.main([
        "depth-nerfacto", "--max-num-iterations", "4", "--steps-per-save", "4",
        "--output-dir", str(out), "--viewer.websocket-port", "0",
        "--logging.steps-per-log", "1",
        "--pipeline.model.num-levels", "3", "--pipeline.model.max-res", "64",
        "--pipeline.model.log2-hashmap-size", "12",
        "--pipeline.model.hidden-dim", "16",
        "--pipeline.model.num-proposal-samples-per-ray", "12", "8",
        "--pipeline.model.num-nerf-samples-per-ray", "6",
        "--pipeline.model.eval-num-rays-per-chunk", "256",
        "--pipeline.datamanager.train-num-rays-per-batch", "128",
        "--pipeline.datamanager.eval-num-rays-per-batch", "128",
        "nerfstudio-data", "--data", str(data)], device=CPU)
    writer._SINKS.remove(sink)
    server = trainer.viewer_server
    try:
        port = server.server_address[1]
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/scene",
                                    timeout=60) as reply:
            scene = json.loads(reply.read())
        assert scene["num_cameras"] == 9 and not scene["has_time"]
    finally:
        server.shutdown()
        server.server_close()
    depth = [v for n, _s, v in sink.scalars if n == "Train Loss Dict/depth_loss"]
    assert len(depth) == 4 and all(np.isfinite(v) and v > 0 for v in depth)
    config = trainer.base_dir / "config.yml"
    info = eval_script.main(["--load-config", str(config), "--output-path",
                             str(tmp_path / "eval.json")], device=CPU)
    assert info["method_name"] == "depth-nerfacto"
    assert all(np.isfinite(info["results"][k]) for k in ("psnr", "ssim"))
    written = render_script.main([
        "--load-config", str(config), "--traj", "spiral",
        "--interpolation-steps", "2", "--output-format", "images",
        "--output-path", str(tmp_path / "spiral.mp4")], device=CPU)
    frames = sorted(written.glob("*.png"))
    assert len(frames) == 2
    assert {Image.open(f).size for f in frames} == {(32, 24)}


def test_fixture_depth_png_is_pillows_mode_i(tmp_path):
    """The port's broadcaststyle depth maps are the bytes Pillow writes for
    the JAX fixture's mode-"I" images."""
    troot = tfix.make_broadcaststyle_fixture(tmp_path / "t", num_cameras=2,
                                             num_steps=1, h=6, w=8,
                                             with_depth=True)
    path = next((troot / "depth-maps-mask" / "2x").glob("*.png"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        Image.fromarray(np.full((6, 8), 300, np.int32), mode="I").save(
            tmp_path / "mode_i.png")
    assert path.read_bytes() == (tmp_path / "mode_i.png").read_bytes()
