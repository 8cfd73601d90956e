"""The port's data path against the JAX package's on the same fixtures.

Parsers (file names, intrinsics, poses, times, camera ids, scene box, the
dataparser's scale and transform, splits, fps_downsample), fixtures and
images (RGBA composited), importance weights
(IST and ISG within one float16 ulp; an even frame count for the median,
the uniform fallback, cameras without ids, the cache files, static ISS),
pixel samplers and the image cache's picks (the same seed gives the same
indices; JAX's C++ loader is patched off so both draw with numpy),
datamanager batches, and the image metrics.
"""
import dataclasses
import json
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from soccernerfs_tpu.data import datasets as jds
from soccernerfs_tpu.data import fixtures as jfix
from soccernerfs_tpu.data import image_cache as jcache
from soccernerfs_tpu.data import importance as jimp
from soccernerfs_tpu.data import native_loader
from soccernerfs_tpu.data import pixel_samplers as jps
from soccernerfs_tpu.data.datamanager import DynamicDataManagerConfig as JDMConfig
from soccernerfs_tpu.data.dataparsers.blender import BlenderDataParserConfig as JBlender
from soccernerfs_tpu.data.dataparsers.soccer import (
    BroadcaststyleDataParserConfig as JBroadcast,
)
from soccernerfs_tpu.utils import metrics as jmetrics
from soccernerfs_tpu_torch.data import datasets as tds
from soccernerfs_tpu_torch.data import fixtures as tfix
from soccernerfs_tpu_torch.data import image_cache as tcache
from soccernerfs_tpu_torch.data import importance as timp
from soccernerfs_tpu_torch.data import pixel_samplers as tps
from soccernerfs_tpu_torch.data.datamanager import DynamicDataManagerConfig as TDMConfig
from soccernerfs_tpu_torch.data.dataparsers import DATAPARSERS
from soccernerfs_tpu_torch.data.dataparsers.blender import BlenderDataParserConfig as TBlender
from soccernerfs_tpu_torch.data.dataparsers.soccer import (
    BroadcaststyleDataParserConfig as TBroadcast,
)
from soccernerfs_tpu_torch.utils import metrics as tmetrics
from soccernerfs_tpu_torch.pipelines import average_eval_image_metrics


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


@pytest.fixture(scope="module")
def broadcast_root(tmp_path_factory):
    return jfix.make_broadcaststyle_fixture(
        tmp_path_factory.mktemp("bstyle"), num_cameras=4, num_steps=4)


@pytest.fixture(scope="module")
def blender_root(tmp_path_factory):
    return jfix.make_blender_fixture(tmp_path_factory.mktemp("blender"),
                                     h=24, w=32)


def _np(x):
    return None if x is None else np.asarray(x.cpu() if torch.is_tensor(x) else x)


def _assert_same_outputs(j, t):
    assert [p.name for p in t.image_filenames] == [p.name for p in j.image_filenames]
    assert t.image_filenames == j.image_filenames
    jc, tc = j.cameras, t.cameras
    for name in ("fx", "fy", "cx", "cy", "width", "height", "distortion_params",
                 "camera_type", "times", "ids"):
        a, b = _np(getattr(jc, name)), _np(getattr(tc, name))
        if a is None:
            assert b is None, name
        else:
            np.testing.assert_array_equal(b, a, err_msg=name)
    np.testing.assert_allclose(_np(tc.camera_to_worlds),
                               _np(jc.camera_to_worlds), atol=1e-6)
    np.testing.assert_array_equal(_np(t.scene_box.aabb), _np(j.scene_box.aabb))
    assert t.dataparser_scale == pytest.approx(j.dataparser_scale, rel=1e-12)
    np.testing.assert_allclose(np.asarray(t.dataparser_transform),
                               np.asarray(j.dataparser_transform), atol=1e-7)
    if j.alpha_color is None:
        assert t.alpha_color is None
    else:
        np.testing.assert_array_equal(t.alpha_color, j.alpha_color)


@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_blender_parser_matches_jax(blender_root, split):
    j = JBlender(data=blender_root).setup().get_dataparser_outputs(split)
    t = TBlender(data=blender_root).setup().get_dataparser_outputs(split)
    _assert_same_outputs(j, t)
    assert t.cameras.camera_to_worlds.device.type == "cpu"


@pytest.mark.parametrize("fps", [1.0, 2.0, 3.0])
@pytest.mark.parametrize("split", ["train", "val"])
def test_broadcaststyle_parser_matches_jax(broadcast_root, split, fps):
    j = JBroadcast(data=broadcast_root, fps_downsample=fps).setup()
    t = TBroadcast(data=broadcast_root, fps_downsample=fps).setup()
    jo, to = j.get_dataparser_outputs(split), t.get_dataparser_outputs(split)
    _assert_same_outputs(jo, to)
    # tests/test_data_layer.py's splits: Camera_1..3 train, Camera_20 eval,
    # linspace(0, 3, 4 // fps) of the 4 steps
    steps = len(np.linspace(0, 3, int(4 / fps))) if fps > 1 else 4
    assert len(to.image_filenames) == (3 if split == "train" else 1) * steps


def test_dataparser_registry_names():
    from soccernerfs_tpu.data.dataparsers import DATAPARSERS as JAX_PARSERS

    # every JAX subcommand, in the JAX registry's order
    assert list(DATAPARSERS) == list(JAX_PARSERS)
    assert len(DATAPARSERS) == 18
    for name, cls in DATAPARSERS.items():
        jcls = JAX_PARSERS[name]
        assert cls.__name__ == jcls.__name__
        assert ([(f.name, f.default) for f in dataclasses.fields(cls)]
                == [(f.name, f.default) for f in dataclasses.fields(jcls)])


def test_dataparser_transform_file(tmp_path, broadcast_root):
    j = JBroadcast(data=broadcast_root).setup().get_dataparser_outputs("train")
    t = TBroadcast(data=broadcast_root).setup().get_dataparser_outputs("train")
    j.save_dataparser_transform(tmp_path / "j.json")
    t.save_dataparser_transform(tmp_path / "t.json")
    jd, td = (json.loads((tmp_path / n).read_text()) for n in ("j.json", "t.json"))
    np.testing.assert_allclose(td["transform"], jd["transform"], atol=1e-7)
    assert td["scale"] == pytest.approx(jd["scale"], rel=1e-12)


@pytest.mark.parametrize("kind", ["blender", "broadcaststyle",
                                  "broadcaststyle-depth"])
def test_fixtures_match_jax(tmp_path, kind):
    """The port writes the JAX fixture's JSON and pixels; its depth maps
    byte for byte."""
    depth = dict(with_depth=True) if kind == "broadcaststyle-depth" else {}
    if kind == "blender":
        jroot = jfix.make_blender_fixture(tmp_path / "j", h=12, w=16)
        troot = tfix.make_blender_fixture(tmp_path / "t", h=12, w=16)
        names = ["transforms_train.json", "transforms_val.json"]
    else:
        jroot = jfix.make_broadcaststyle_fixture(tmp_path / "j", num_cameras=3,
                                                 num_steps=2, h=12, w=16, **depth)
        troot = tfix.make_broadcaststyle_fixture(tmp_path / "t", num_cameras=3,
                                                 num_steps=2, h=12, w=16, **depth)
        names = ["transforms.json"]
    for n in names:
        assert (json.loads((troot / n).read_text())
                == json.loads((jroot / n).read_text()))
    pngs = sorted(p.relative_to(jroot) for p in jroot.rglob("*.png"))
    assert pngs == sorted(p.relative_to(troot) for p in troot.rglob("*.png"))
    for rel in pngs:
        with Image.open(troot / rel) as t, Image.open(jroot / rel) as j:
            assert t.mode == j.mode
            np.testing.assert_array_equal(np.asarray(t), np.asarray(j))
    depths = [rel for rel in pngs if rel.parts[0] == "depth-maps-mask"]
    assert len(depths) == (6 if depth else 0)
    for rel in depths:
        assert (troot / rel).read_bytes() == (jroot / rel).read_bytes()


@pytest.mark.parametrize("alpha", [None, "white", "black"])
def test_images_match_jax(blender_root, broadcast_root, alpha):
    color = None if alpha is None else np.asarray(
        {"white": (1.0, 1.0, 1.0), "black": (0.0, 0.0, 0.0)}[alpha], np.float32)
    files = [blender_root / "train" / "r_0.png",  # RGBA
             next((broadcast_root / "images" / "2x").glob("*.png"))]  # RGB
    for f in files:
        np.testing.assert_array_equal(tds.get_image(f, 1.0, color),
                                      jds.get_image(f, 1.0, color))


@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_masks_match_jax(tmp_path, scale):
    rng = np.random.default_rng(7)
    for mode, shape in (("L", (12, 16)), ("RGB", (12, 16, 3))):
        path = tmp_path / f"mask_{mode}.png"
        Image.fromarray((rng.random(shape) < 0.5).astype(np.uint8) * 255,
                        mode=mode).save(path)
        got = tds.get_mask(path, scale)
        np.testing.assert_array_equal(got, jds.get_mask(path, scale))
        assert got.dtype == np.bool_ and got.shape == (int(12 * scale), int(16 * scale))


def test_scaled_image_matches_jax(blender_root):
    f = blender_root / "train" / "r_1.png"
    np.testing.assert_array_equal(tds.get_image(f, 0.5), jds.get_image(f, 0.5))


def test_depth_maps_are_refused(tmp_path):
    """Depth maps were refused before the depth losses came; now the
    dynamic dataset reads them: each item's "depth_image" equals JAX's (the
    parser's 0.01 unit times its scale, at the camera's size), and a
    dataset without depth files adds none."""
    root = jfix.make_broadcaststyle_fixture(tmp_path / "b", num_cameras=3,
                                            num_steps=2, with_depth=True)
    parser = dict(data=root, fps_downsample=1.0, depth_maps="depth-maps")
    jo = JBroadcast(**parser).setup().get_dataparser_outputs("train")
    to = TBroadcast(**parser).setup().get_dataparser_outputs("train")
    assert to.metadata == jo.metadata
    jd, td = jds.DynamicDataset(jo), tds.DynamicDataset(to, device="cpu")
    for i in range(len(td)):
        got, want = td[i], jd[i]
        assert got.keys() == want.keys() and "depth_image" in got
        np.testing.assert_array_equal(got["depth_image"], want["depth_image"])
        assert got["depth_image"].shape == got["image"].shape[:2]
        np.testing.assert_allclose(got["depth_image"],
                                   3.0 * to.dataparser_scale, rtol=1e-6)
    plain = TBroadcast(data=root, fps_downsample=1.0).setup()
    assert "depth_image" not in tds.DynamicDataset(
        plain.get_dataparser_outputs("train"), device="cpu")[0]


# ---------------------------------------------------------------- importance


def _datasets(root, fps=1.0, ids=True, **is_cfg):
    jo = JBroadcast(data=root, fps_downsample=fps).setup().get_dataparser_outputs("train")
    to = TBroadcast(data=root, fps_downsample=fps).setup().get_dataparser_outputs("train")
    if not ids:
        jo.cameras = jo.cameras.replace(ids=None)
        to.cameras = dataclasses.replace(to.cameras, ids=None)
    jd = jds.DynamicDataset(jo, is_config=jds.ImportanceSamplingConfig(**is_cfg))
    td = tds.DynamicDataset(to, is_config=tds.ImportanceSamplingConfig(**is_cfg),
                            device="cpu")
    batch = {"image_idx": np.arange(len(jd)),
             "image": np.stack([jd.get_image(i) for i in range(len(jd))])}
    return jd, td, batch


def _within_f16_ulp(a, b):
    a32, b32 = np.asarray(a, np.float32), np.asarray(b, np.float32)
    ulp = np.spacing(np.maximum(np.abs(a32), np.abs(b32)).astype(np.float16))
    bad = np.abs(a32 - b32) > ulp.astype(np.float32)
    assert a.dtype == b.dtype == np.float16 and a.shape == b.shape
    assert not bad.any(), (bad.sum(), np.abs(a32 - b32).max())


@pytest.mark.parametrize("ist_range", [1.0, 0.5, 0.02])
@pytest.mark.parametrize("fps", [1.0, 2.0])  # 4 and 2 frames per camera
def test_ist_matches_jax(broadcast_root, ist_range, fps):
    jd, td, batch = _datasets(broadcast_root, fps)
    j = jimp.compute_ist(jd, batch, ist_range=ist_range, split="train")
    t = timp.compute_ist(td, batch, ist_range=ist_range, split="train",
                         device="cpu")
    _within_f16_ulp(t, j)
    gap = 1 / 3 if fps == 1.0 else 1.0  # between a camera's frames
    if ist_range < gap:  # no close frames: uniform 1s
        assert (t == 1).all()
    else:
        assert (t > 0).any() and (t == 0).mean() > 0.5


@pytest.mark.parametrize("frames", [4, 3], ids=["even", "odd"])
@pytest.mark.parametrize("ids", [True, False], ids=["ids", "no-ids"])
def test_isg_matches_jax(broadcast_root, frames, ids):
    """ISG's temporal median of an even frame count is the mean of the
    two middle values (``jnp.median``), not the lower one (``torch.median``)."""
    jd, td, batch = _datasets(broadcast_root, ids=ids)
    keep = np.nonzero(np.asarray(jd.cameras.times)[batch["image_idx"]]
                      <= (frames - 1) / 3 + 1e-6)[0]
    batch = {"image_idx": batch["image_idx"][keep], "image": batch["image"][keep]}
    j = jimp.compute_isg(jd, batch, gamma=5e-2, split="train")
    t = timp.compute_isg(td, batch, gamma=5e-2, split="train", device="cpu")
    _within_f16_ulp(t, j)
    if frames == 4:
        # torch.median's lower middle value differs from the midpoint here
        images = torch.from_numpy(batch["image"][:4])
        ordered = torch.sort(images, dim=0).values
        assert not torch.equal(torch.median(images, dim=0).values,
                               (ordered[1] + ordered[2]) * 0.5)


@pytest.mark.parametrize("ids", [True, False], ids=["ids", "no-ids"])
def test_ist_without_times_or_ids(broadcast_root, ids):
    jd, td, batch = _datasets(broadcast_root, ids=ids)
    _within_f16_ulp(timp.compute_ist(td, batch, 1.0, "train", device="cpu"),
                    jimp.compute_ist(jd, batch, 1.0, "train"))
    td.cameras = dataclasses.replace(td.cameras, times=None)
    assert timp.compute_ist(td, batch, 1.0, "train", device="cpu") is None
    assert timp.compute_isg(td, batch, 5e-2, "train", device="cpu") is None


def test_importance_cache_files(broadcast_root):
    """offline=True writes the JAX package's cache file names and reads a
    file of the right batch back instead of computing."""
    jd, td, batch = _datasets(broadcast_root)
    b, h = batch["image"].shape[:2]
    folder = td.image_filenames[0].parent
    for f in folder.glob("*-weights-*.npy"):
        f.unlink()
    t = timp.compute_ist(td, batch, 1.0, "train", offline=True, device="cpu")
    name = f"ist-weights-1_0-train-{b}-{h}p.npy"
    np.testing.assert_array_equal(np.load(folder / name), t)
    np.save(folder / name, np.zeros_like(t))
    assert not timp.compute_ist(td, batch, 1.0, "train", offline=True,
                                device="cpu").any()
    g = timp.compute_isg(td, batch, 0.05, "eval", offline=True, device="cpu")
    np.testing.assert_array_equal(np.load(folder / f"isg-weights-0.05-eval-{b}-{h}p.npy"), g)
    s = timp.compute_iss(td, batch, "train", offline=True)
    assert s.dtype == np.float16 and (s == 1).all()
    np.testing.assert_array_equal(
        s, jimp.compute_iss(jd, batch, "train", offline=True))
    for f in folder.glob("*-weights-*.npy"):
        f.unlink()


def test_static_dataset_uses_iss(broadcast_root):
    jd, td, batch = _datasets(broadcast_root)
    td.metadata["static"] = True
    out = td.compute_is(batch)
    assert out.shape == batch["image"].shape[:3] and (out == 1).all()


# ------------------------------------------------------- samplers and cache


def _image_batch(broadcast_root, iter_steps=10):
    jd, _td, batch = _datasets(broadcast_root)
    batch["ist_weights"] = jimp.compute_ist(jd, batch, ist_range=1.0, split="train")
    batch["iter_steps"] = iter_steps
    return batch


@pytest.mark.parametrize("cls", ["PixelSampler", "EquirectangularPixelSampler",
                                 "PatchPixelSampler"])
def test_uniform_samplers_match_jax(broadcast_root, cls):
    batch = _image_batch(broadcast_root)
    kw = {"patch_size": 4} if cls == "PatchPixelSampler" else {}
    j = getattr(jps, cls)(256, seed=7, **kw)
    t = getattr(tps, cls)(256, seed=7, **kw)
    for _ in range(3):
        a, b = j.sample(batch), t.sample(batch)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)


@pytest.mark.parametrize("iter_steps", [1, 10])  # before and after IS starts
def test_importance_sampler_matches_jax(broadcast_root, iter_steps):
    batch = _image_batch(broadcast_root, iter_steps)
    j = jps.DynamicBasedPixelSampler(512, is_pixel_ratio=0.15,
                                     iters_to_start_is=5, seed=3)
    t = tps.DynamicBasedPixelSampler(512, is_pixel_ratio=0.15,
                                     iters_to_start_is=5, seed=3)
    for _ in range(3):
        a, b = j.sample(batch), t.sample(batch)
        np.testing.assert_array_equal(b["indices"], a["indices"])
        np.testing.assert_array_equal(b["image"], a["image"])
    # after the start, floor(0.15 * 512) rays come from the weight maps
    if iter_steps > 5:
        w = batch["ist_weights"]
        rows = b["indices"][:76]
        slot = np.searchsorted(batch["image_idx"], rows[:, 0])
        assert (w[slot, rows[:, 1], rows[:, 2]] > 0).all()


@pytest.mark.parametrize("pick_mode", ["normal", "randsteps", "lowfps"])
def test_cache_picks_match_jax(broadcast_root, pick_mode):
    """Three refreshes of a cache of 6 of the 12 train images, IST weights
    attached once ``iter_step + repeat >= iters_to_start_is``: the same
    images, in the same order, with the same weights."""
    cfg = dict(ist_range=1.0, iters_to_start_is=5, pick_mode=pick_mode)
    jd, td, _ = _datasets(broadcast_root, **cfg)
    random.seed(11)
    j = jcache.ImageBatchCache(jd, 6, 2)
    t = tcache.ImageBatchCache(td, 6, 2, rng=random.Random(11))
    for step in range(7):
        a, b = j.next_batch(), t.next_batch()
        np.testing.assert_array_equal(b["image_idx"], a["image_idx"])
        np.testing.assert_array_equal(b["image"], a["image"])
        assert b["iter_steps"] == a["iter_steps"] == step + 1
        assert ("ist_weights" in b) == ("ist_weights" in a)
        if "ist_weights" in a:
            _within_f16_ulp(b["ist_weights"], a["ist_weights"])
    assert "ist_weights" in b


def _managers(root, **extra):
    common = dict(train_num_rays_per_batch=64, eval_num_rays_per_batch=32,
                  train_num_images_to_sample_from=6,
                  train_num_times_to_repeat_images=2,
                  eval_num_images_to_sample_from=2,
                  eval_num_times_to_repeat_images=1, use_importance_sampling=True,
                  iters_to_start_is=2, ist_range=1.0, **extra)
    random.seed(5)
    j = JDMConfig(dataparser=JBroadcast(data=root, fps_downsample=1.0),
                  **common).setup(seed=5)
    t = TDMConfig(dataparser=TBroadcast(data=root, fps_downsample=1.0),
                  **common).setup(seed=5, device="cpu")
    return j, t


@pytest.mark.parametrize("pick_mode", ["randsteps", "normal"])
def test_datamanager_batches_match_jax(broadcast_root, pick_mode):
    """Train and eval batches, interleaved (both caches draw from one
    ``random`` stream, as JAX's from the global one)."""
    j, t = _managers(broadcast_root, pick_mode=pick_mode)
    for step in range(6):
        for name in ("next_train_raw", "next_eval_raw"):
            a, b = getattr(j, name)(step), getattr(t, name)(step)
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(b[k], a[k], err_msg=f"{name} {k}")
    rays, batch = t.next_train(6)
    jrays, jbatch = j.next_train(6)
    np.testing.assert_array_equal(batch["indices"], jbatch["indices"])
    np.testing.assert_allclose(rays.origins.numpy(), np.asarray(jrays.origins),
                               atol=1e-6)
    np.testing.assert_allclose(rays.directions.numpy(),
                               np.asarray(jrays.directions), atol=1e-6)
    np.testing.assert_array_equal(rays.times.numpy(), np.asarray(jrays.times))
    idx, image_rays, data = t.next_eval_image(5)
    jidx, jimage_rays, jdata = j.next_eval_image(5)
    assert idx == jidx
    np.testing.assert_array_equal(data["image"], jdata["image"])
    np.testing.assert_allclose(image_rays.directions.numpy(),
                               np.asarray(jimage_rays.directions), atol=1e-6)


def test_device_batch_matches_jax(broadcast_root, tmp_path):
    """``Trainer._device_batch`` equals the JAX trainer's on the same raw
    batch (called on stand-ins holding what each method reads)."""
    import types

    import jax

    from soccernerfs_tpu.engine.trainer import Trainer as JTrainer
    from soccernerfs_tpu.parallel import mesh as meshlib
    from soccernerfs_tpu_torch.engine.trainer import Trainer as TTrainer

    _j, t = _managers(broadcast_root)
    raw = t.next_train_raw(0)
    jb = JTrainer._device_batch(
        types.SimpleNamespace(mesh=meshlib.make_data_mesh(jax.devices()[:1])), raw)
    tb = TTrainer._device_batch(types.SimpleNamespace(device=torch.device("cpu")), raw)
    assert jb.keys() == tb.keys()
    for k in jb:
        a = np.asarray(jb[k])
        assert tb[k].numpy().dtype == a.dtype, k
        np.testing.assert_array_equal(tb[k].numpy(), a, err_msg=k)


# ------------------------------------------------------------------ metrics


def _pair(seed, h=48, w=48):
    """tests/test_ops_numerics.py's SSIM inputs: a [0.3, 0.7] image and
    the same with N(0, 0.02) noise."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0.3, 0.7, (h, w, 3))
    pred = np.clip(base + rng.normal(0, 0.02, base.shape), 0, 1)
    return base.astype(np.float32), pred.astype(np.float32)


def _ssim_f64(x, y):
    """tests/test_ops_numerics.py's float64 reference: valid windows of
    the 11x11, sigma 1.5 Gaussian."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    g = np.exp(-((np.arange(11) - 5.0) ** 2) / (2 * 1.5**2))
    g /= g.sum()
    k = np.outer(g, g)

    def filt(a):
        H, W = a.shape[:2]
        out = np.zeros((H - 10, W - 10, a.shape[2]))
        for i in range(11):
            for j in range(11):
                out += k[i, j] * a[i:i + H - 10, j:j + W - 10]
        return out

    c1, c2 = 0.01**2, 0.03**2
    mx, my = filt(x), filt(y)
    sxx = filt(x * x) - mx**2
    syy = filt(y * y) - my**2
    sxy = filt(x * y) - mx * my
    return float(np.mean((2 * mx * my + c1) * (2 * sxy + c2)
                         / ((mx**2 + my**2 + c1) * (sxx + syy + c2))))


@pytest.mark.parametrize("seed", [3, 0])
def test_psnr_ssim_match_jax_and_f64(seed):
    """Within tests/test_ops_numerics.py's 2e-5 of the float64 SSIM (JAX's
    convolutions at Precision.HIGHEST; the port's with TF32 off)."""
    base, pred = _pair(seed)
    for a, b in ((pred, base), (base, base)):
        ta, tb = torch.from_numpy(a), torch.from_numpy(b)
        np.testing.assert_allclose(float(tmetrics.psnr(ta, tb)),
                                   float(jmetrics.psnr(jnp.asarray(a), jnp.asarray(b))),
                                   rtol=1e-6)
        t = float(tmetrics.ssim(ta, tb))
        assert t <= 1.0 + 1e-6
        np.testing.assert_allclose(t, _ssim_f64(a, b), atol=2e-5)
        np.testing.assert_allclose(
            t, float(jmetrics.ssim(jnp.asarray(a), jnp.asarray(b))), atol=2e-5)


def test_ssim_restores_tf32_flags():
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    seen = []
    try:
        real = torch.nn.functional.conv2d

        def spy(*a, **k):
            seen.append((torch.backends.cudnn.allow_tf32,
                         torch.backends.cuda.matmul.allow_tf32))
            return real(*a, **k)

        tmetrics.F.conv2d = spy
        base, noisy = _pair(3)
        tmetrics.ssim(torch.from_numpy(base), torch.from_numpy(noisy))
        assert seen and all(s == (False, False) for s in seen)
        assert (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32) == (True, True)
    finally:
        tmetrics.F.conv2d = real
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def test_lpips_nan_and_average_reports_none(monkeypatch):
    import types

    monkeypatch.delenv("SNT_LPIPS_WEIGHTS", raising=False)
    base, noisy = _pair(4)
    m = tmetrics.all_image_metrics(noisy, base, device="cpu")
    assert np.isnan(m["lpips"]) and np.isnan(jmetrics.lpips(jnp.asarray(noisy),
                                                            jnp.asarray(base)))
    assert m["psnr"] == pytest.approx(float(jmetrics.psnr(jnp.asarray(noisy),
                                                          jnp.asarray(base))), rel=1e-6)

    class Eval:
        def __len__(self):
            return 2

    trainer = types.SimpleNamespace(
        device=torch.device("cpu"), eval_cameras=None,
        datamanager=types.SimpleNamespace(
            eval_dataset=Eval(),
            next_eval_image=lambda i: (i, None, {"image": base})),
        render_camera=lambda cams, i: {"rgb": noisy if i == 0 else base})
    out = average_eval_image_metrics(trainer)
    assert out["lpips"] is None
    assert out["psnr"] == pytest.approx((m["psnr"] + 120.0) / 2, rel=1e-6)
    assert out["ssim"] == pytest.approx((m["ssim"] + 1.0) / 2, rel=1e-6)


def test_all_image_metrics_on_cuda_by_default(monkeypatch):
    """The entry point runs on CUDA unless the caller names a device, host
    arrays included, and raises when CUDA is absent."""
    base, noisy = _pair(5)
    if not torch.cuda.is_available():
        for a, b in ((noisy, base), (torch.from_numpy(noisy), torch.from_numpy(base))):
            with pytest.raises(RuntimeError, match="CUDA"):
                tmetrics.all_image_metrics(a, b)
    seen = []
    monkeypatch.setattr(tmetrics, "resolve_device",
                        lambda d: seen.append(d) or torch.device("cpu"))
    m = tmetrics.all_image_metrics(noisy, base)
    assert seen == [None]
    assert m["psnr"] == pytest.approx(float(jmetrics.psnr(jnp.asarray(noisy),
                                                          jnp.asarray(base))), rel=1e-6)


def _write_lpips_weights(path, seed):
    """Random AlexNet-shaped weights in the JAX package's .npz layout."""
    rng = np.random.default_rng(seed)
    arrays, cin = {}, 3
    for i, (cout, k, _, _) in enumerate(jmetrics._ALEX_LAYERS):
        arrays[f"conv{i}_w"] = (rng.normal(size=(cout, cin, k, k))
                                / np.sqrt(cin * k * k)).astype(np.float32)
        arrays[f"conv{i}_b"] = rng.normal(scale=0.1, size=cout).astype(np.float32)
        arrays[f"lin{i}_w"] = np.abs(rng.normal(size=(1, cout, 1, 1))).astype(np.float32)
        cin = cout
    np.savez(path, **arrays)


@pytest.mark.parametrize("seed", [0, 1])
def test_lpips_matches_jax_with_local_weights(tmp_path, monkeypatch, seed):
    """The AlexNet path (input scaling, convolutions, pools, channel
    normalisation, linear heads) against JAX's on the same local weights;
    the port reads the file once per device."""
    path = tmp_path / "alex.npz"
    _write_lpips_weights(path, seed)
    monkeypatch.setenv("SNT_LPIPS_WEIGHTS", str(path))
    monkeypatch.setattr(jmetrics, "_lpips_weights_cache", None)
    monkeypatch.setattr(tmetrics, "_lpips_weights_cache", {})
    base, noisy = _pair(seed, 64, 80)
    for a, b in ((noisy, base), (1.0 - base, base), (base, base)):
        want = jmetrics.lpips(jnp.asarray(a), jnp.asarray(b))
        got = tmetrics.lpips(torch.from_numpy(a), torch.from_numpy(b))
        assert np.isfinite(want) and (want > 0 or a is base)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    cpu = torch.device("cpu")
    assert tmetrics._load_lpips_weights(cpu) is tmetrics._load_lpips_weights(cpu)
    m = tmetrics.all_image_metrics(noisy, base, device="cpu")
    assert m["lpips"] == pytest.approx(
        jmetrics.lpips(jnp.asarray(noisy), jnp.asarray(base)), rel=1e-5)
