"""HyperNeRF data in the port (soccernerfs_tpu_torch/data/dataparsers/hypernerf.py,
data/fixtures.make_hypernerf_fixture) against the JAX package on the CPU:
the parser field by field on one fixture layout (file names, poses,
intrinsics, distortion, times, ids and the interleaved split), the
distorted cameras' rays against JAX's ``generate_rays``, and one K-Planes
train step on those cameras with ``bounded`` false (constant near and far,
piecewise spacing, scene contraction, as experiments/hypernerf_kplanes.py
trains) and true, against ``jax.value_and_grad``; then ``Trainer.train``
over the fixture with both settings.

Small sizes: 2 sides x 6 steps at 12 x 16, K-Planes at 8^3 x 5 planes,
96 rays.  Inputs are made with numpy from a seed; JAX's own draws are
handed to the port; every tolerance is stated with its reason.
"""
import copy
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from soccernerfs_tpu.configs.method_configs import method_configs
from soccernerfs_tpu.core import cameras as jcam
from soccernerfs_tpu.data.dataparsers import DATAPARSERS as JAX_DATAPARSERS
from soccernerfs_tpu.data.dataparsers.hypernerf import (
    HyperNeRFDataParserConfig as JaxHyperNeRFConfig,
)
from soccernerfs_tpu.models import kplanes as jk
from soccernerfs_tpu_torch import convert
from soccernerfs_tpu_torch.configs import method_configs as tmc
from soccernerfs_tpu_torch.core import cameras as tcam
from soccernerfs_tpu_torch.data.dataparsers import DATAPARSERS
from soccernerfs_tpu_torch.data.dataparsers.hypernerf import HyperNeRFDataParserConfig
from soccernerfs_tpu_torch.data.fixtures import make_hypernerf_fixture
from soccernerfs_tpu_torch.engine.trainer import Trainer, TrainStep
from soccernerfs_tpu_torch.models import kplanes as tk
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
H, W, TIMES = 12, 16, 6
N_RAYS = 96
TINY = dict(
    spacetime_resolution=(8, 8, 8, 5),
    feature_dim=8,
    multiscale_res=(1, 2),
    proposal_net_args_list=(
        {"feature_dim": 8, "resolution": (8, 8, 8, 5)},
        {"feature_dim": 8, "resolution": (16, 16, 16, 5)},
    ),
    num_proposal_samples_per_ray=(24, 16),
    num_nerf_samples_per_ray=16,
    sigma_net_hidden_dim=32,
    rgb_net_hidden_dim=32,
    eval_num_rays_per_chunk=256,
)


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


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return make_hypernerf_fixture(tmp_path_factory.mktemp("hypernerf"),
                                  num_times=TIMES, h=H, w=W)


def _both(data, split):
    port = HyperNeRFDataParserConfig(data=data).setup().get_dataparser_outputs(split)
    ref = JaxHyperNeRFConfig(data=data).setup().get_dataparser_outputs(split)
    return port, ref


# ---------------------------------------------------------------------------
# the parser
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("split", ["train", "val"])
def test_parser_matches_jax(data, split):
    """Every field of the parsed split equals the JAX parser's: file names,
    c2w (f32, exact: the same float64 arithmetic), intrinsics, image
    sizes, distortion, times, ids, the scene box and the scale."""
    port, ref = _both(data, split)
    assert port.image_filenames == ref.image_filenames
    pc, rc = port.cameras, ref.cameras
    for name in ("camera_to_worlds", "fx", "fy", "cx", "cy", "width", "height",
                 "distortion_params", "times", "ids"):
        got, want = _np(getattr(pc, name)), np.asarray(getattr(rc, name))
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert int(pc.camera_type[0]) == int(np.asarray(rc.camera_type)[0])
    np.testing.assert_array_equal(_np(port.scene_box.aabb),
                                  np.asarray(ref.scene_box.aabb))
    assert port.dataparser_scale == ref.dataparser_scale


def test_fixture_layout_and_split(data):
    """The nerfies layout: scene.json, one camera file per side and step,
    the 2x images at h x w; the split interleaves the sides (left/even and
    right/odd train), times are step / max step, ids the side, and the
    fixture's distortions are nonzero."""
    assert (data / "scene.json").is_file()
    assert len(list((data / "camera").glob("*.json"))) == 2 * TIMES
    assert len(list((data / "rgb" / "2x").glob("*.png"))) == 2 * TIMES
    train, _ = _both(data, "train")
    val, _ = _both(data, "val")
    names = [p.stem for p in train.image_filenames]
    assert names == [f"left_{t:05d}" for t in range(0, TIMES, 2)] + [
        f"right_{t:05d}" for t in range(1, TIMES, 2)]
    assert len(val.image_filenames) == TIMES
    assert not set(names) & {p.stem for p in val.image_filenames}
    np.testing.assert_allclose(_np(train.cameras.times),
                               [int(n[-5:]) / (TIMES - 1) for n in names])
    np.testing.assert_array_equal(_np(train.cameras.ids),
                                  [n.startswith("right") for n in names])
    dist = _np(train.cameras.distortion_params)
    assert (dist[:, [0, 1, 4, 5]] != 0).all() and (dist[:, 3] == 0).all()
    assert int(train.cameras.width[0]) == W and int(train.cameras.height[0]) == H


def test_registered():
    assert set(JAX_DATAPARSERS) >= {"hypernerf-data", "dnerf-data"}
    assert DATAPARSERS["hypernerf-data"] is HyperNeRFDataParserConfig
    assert DATAPARSERS["dnerf-data"].__name__ == "DNeRFDataParserConfig"
    for name in ("hypernerf-data", "dnerf-data"):
        port, ref = DATAPARSERS[name](), JAX_DATAPARSERS[name]()
        assert dataclasses.asdict(port) == dataclasses.asdict(ref), name


def test_distorted_rays_match_jax(data):
    """The train cameras' rays (undistorted through the fixture's radial
    and tangential terms) at random pixels: origins exact, directions
    within 1e-6 (the fixed-iteration undistortion in f32 on both sides),
    pixel areas within 1e-6 relative, times exact; and the undistortion
    moved the directions."""
    port, ref = _both(data, "train")
    rng = np.random.default_rng(0)
    n = 200
    idx = rng.integers(0, len(port.image_filenames), n).astype(np.int32)
    coords = np.stack([rng.uniform(0, H, n), rng.uniform(0, W, n)], -1).astype(np.float32)
    want = jcam.generate_rays(ref.cameras, jnp.asarray(idx), jnp.asarray(coords))
    got = tcam.generate_rays(port.cameras, _t(idx), _t(coords))
    np.testing.assert_array_equal(_np(got.origins), np.asarray(want.origins))
    assert np.abs(_np(got.directions) - np.asarray(want.directions)).max() <= 1e-6
    assert _rel(got.pixel_area, want.pixel_area) <= 1e-6
    np.testing.assert_array_equal(_np(got.times), np.asarray(want.times))
    plain = tcam.generate_rays(port.cameras, _t(idx), _t(coords),
                               disable_distortion=True)
    assert np.abs(_np(plain.directions) - _np(got.directions)).max() > 1e-4


# ---------------------------------------------------------------------------
# K-Planes on those cameras
# ---------------------------------------------------------------------------

def _batch(n_cams, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "cam_idx": rng.integers(0, n_cams, N_RAYS).astype(np.int32),
        "coords": np.stack([rng.uniform(0, H, N_RAYS), rng.uniform(0, W, N_RAYS)],
                           -1).astype(np.float32),
        "image": rng.uniform(0, 1, (N_RAYS, 3)).astype(np.float32),
    }


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


def _jax_draws(cfg, key, n):
    """get_outputs' draws from its key: (sampling, background); one
    stratified uniform [N, S + 1] per level; the [N, 3] background."""
    rng_sample, rng_bg = jax.random.split(key)
    keys = jax.random.split(rng_sample, cfg.num_proposal_iterations + 1)
    counts = [*cfg.num_proposal_samples_per_ray, cfg.num_nerf_samples_per_ray]
    jitters = [_t(jax.random.uniform(k, (n, s + 1))) for k, s in zip(keys, counts)]
    return jitters, _t(jax.random.uniform(rng_bg, (n, 3)))


@pytest.mark.parametrize("bounded", [False, True])
def test_kplanes_step_on_hypernerf_matches_jax(data, bounded):
    """One K-Planes train step at step 300 (a proposal update) on the
    HyperNeRF train cameras (distortion, times), ``bounded`` false and
    true: the loss, every loss term and PSNR within 1e-4 relative, every
    gradient leaf within 1e-2 in L2, against jax.value_and_grad with the
    same params, batch and draws.  L2 per leaf: JAX's CPU path gathers the
    planes from bf16 tables and adds their cotangents in bf16, the port in
    f32, which moves single elements by ~1e-2 of a leaf's max."""
    port, ref = _both(data, "train")
    jcfg = dataclasses.replace(method_configs["k-planes"].pipeline.model,
                               **TINY, bounded=bounded)
    tcfg = dataclasses.replace(tmc.model_configs["k-planes"], **TINY,
                               bounded=bounded)
    np_tree = _time_noise(jax.tree_util.tree_map(
        np.asarray, jax.jit(jk.init, static_argnums=1)(jax.random.PRNGKey(0), jcfg)))
    aabb = jnp.asarray(_np(port.scene_box.aabb))
    step = 300
    batch = _batch(len(port.image_filenames))
    key = jax.random.PRNGKey(11)

    def loss_fn(p, b):
        rays = jcam.generate_rays(ref.cameras, b["cam_idx"], b["coords"])
        outputs = jk.get_outputs(jcfg, p, aabb, rays, rng=key, train=True,
                                 anneal=jk.proposal_anneal(jcfg, step),
                                 train_proposal_networks=True)
        metrics = jk.get_metrics_dict(jcfg, outputs, b, step)
        loss_dict = jk.get_loss_dict(jcfg, p, outputs, b, metrics, train=True)
        return functools.reduce(jnp.add, loss_dict.values()), (loss_dict, metrics)

    (jloss, (jld, jmet)), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(jax.tree_util.tree_map(jnp.asarray, np_tree),
                                {k: jnp.asarray(v) for k, v in batch.items()})
    trainer = TrainStep(tcfg, port.cameras, port.scene_box.aabb,
                        tmc.optimizer_configs["k-planes"], device=CPU)
    state = trainer.init_state(convert.params_from_jax(np_tree, device=CPU))
    state.step = step
    jitters, background = _jax_draws(tcfg, key, N_RAYS)
    loss, ld, met, grads = trainer.loss_and_grads(
        state, {k: _t(v) for k, v in batch.items()}, train_proposal_networks=True,
        jitters=jitters, background=background)
    assert set(jld) == set(ld)
    assert _rel(loss, jloss) <= 1e-4
    for k in jld:
        assert _rel(ld[k], jld[k]) <= 1e-4, k
    assert _rel(met["psnr"], jmet["psnr"]) <= 1e-4
    jflat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert len(jflat) == len(grads)
    for (path, jg), g in zip(jflat, grads):
        assert g is not None and tuple(g.shape) == jg.shape, path
        assert _l2(g, jg) <= 1e-2, (jax.tree_util.keystr(path), _l2(g, jg))
    # the unbounded path: constant planes and the piecewise sampler
    rays = tcam.generate_rays(trainer.cameras, _t(batch["cam_idx"]), _t(batch["coords"]))
    near_far = tk.set_nears_and_fars(tcfg, rays, trainer.aabb)
    if not bounded:
        assert float(near_far.nears.min()) == np.float32(tcfg.near_plane)
        assert float(near_far.fars.max()) == np.float32(tcfg.far_plane)


@pytest.mark.parametrize("bounded", [False, True])
def test_kplanes_trains_on_hypernerf(tmp_path, data, bounded):
    """Trainer.train of k-planes (its registered DynamicDataManager with
    IST from step 2) on the fixture for 6 steps, eval batches and an eval
    image on the way: finite losses, the params move, an eval image of the
    eval split renders finite at its size."""
    cfg = copy.deepcopy(tmc.trainer_configs["k-planes"])
    cfg.pipeline.model = dataclasses.replace(cfg.pipeline.model, **TINY,
                                             bounded=bounded)
    dm = cfg.pipeline.datamanager
    dm.dataparser = DATAPARSERS["hypernerf-data"](data=data)
    dm.train_num_rays_per_batch = 64
    dm.eval_num_rays_per_batch = 32
    dm.train_num_images_to_sample_from = -1
    dm.eval_num_images_to_sample_from = -1
    dm.iters_to_start_is = 2
    cfg.max_num_iterations = 6
    cfg.steps_per_save = 0
    cfg.steps_per_eval_batch = 3
    cfg.steps_per_eval_image = 3
    cfg.steps_per_eval_all_images = 0
    cfg.vis = "none"
    cfg.output_dir = tmp_path / "out"
    cfg.set_timestamp()
    trainer = Trainer(cfg, device=CPU).setup()
    before = [x.detach().clone() for x in tree_leaves(trainer.state.params)]
    trainer.train()
    assert trainer.state.step == 6
    assert all(not torch.equal(a, b.detach()) for a, b in
               zip(before, tree_leaves(trainer.state.params))
               if b.ndim == 3 and b.shape[-1] == 8)
    out = trainer.render_camera(trainer.eval_cameras, 0)
    assert out["rgb"].shape == (H, W, 3) and np.isfinite(out["rgb"]).all()
    assert np.isfinite(trainer.eval_image(0)["psnr"])
