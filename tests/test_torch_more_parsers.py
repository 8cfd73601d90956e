"""The remaining dataparsers of the port against the JAX package's.

instant-ngp, minimal, phototourism, dycheck, sdfstudio, scannet and
arkitscenes read the same files (the port's fixtures, written from a seed)
in both packages: file names, every camera tensor, times, the scene box,
the dataparser's scale and transform and the metadata agree within 1e-6
on the train and the eval split.  nuscenes refuses alike; the registry is
JAX's, name for name and in order, and ``snt-train`` takes each new name;
images of mixed sizes are refused by both image caches alike; the
sdfstudio splits are the same frames; each train split's first image
loads at its camera's size.
"""
import dataclasses
import random
import shutil
import sys
import types

import numpy as np
import pytest
import torch

from soccernerfs_tpu.configs.cli import parse_train_cli as jparse
from soccernerfs_tpu.data import datasets as jds
from soccernerfs_tpu.data import image_cache as jcache
from soccernerfs_tpu.data import native_loader
from soccernerfs_tpu_torch.data import native_loader as tnative
from soccernerfs_tpu.data.dataparsers import DATAPARSERS as JAX_PARSERS
from soccernerfs_tpu_torch.configs.cli import parse_train_cli as tparse
from soccernerfs_tpu_torch.data import datasets as tds
from soccernerfs_tpu_torch.data import fixtures as tfix
from soccernerfs_tpu_torch.data import image_cache as tcache
from soccernerfs_tpu_torch.data.dataparsers import DATAPARSERS

NEW = ("minimal-parser", "instant-ngp-data", "phototourism-data",
       "dycheck-data", "sdfstudio-data", "scannet-data", "arkitscenes-data",
       "nuscenes-data")
TOL = 1e-6
H, W = 12, 16


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
    """Both packages' data-path runtimes off (JAX's C++ loader, which its
    sampler and cache use when it loads, and the port's counterpart):
    both draw with numpy's choice and decode through their datasets."""
    monkeypatch.setattr(native_loader, "available", lambda: False)
    monkeypatch.setattr(tnative, "available", lambda: False)


def _sparse0(root):
    """The phototourism layout with its model under sparse/0."""
    shutil.move(str(root / "dense" / "sparse"), str(root / "sparse" / "0"))
    return root


# name: (parser, fixture writer, its arguments, parser arguments, then the
# data path from the fixture's root)
CASES = {
    "instant-ngp": ("instant-ngp-data", tfix.make_instant_ngp_fixture,
                    dict(aabb_scale=2), {}, None),
    "instant-ngp json": ("instant-ngp-data", tfix.make_instant_ngp_fixture,
                         {}, dict(scene_scale=0.5),
                         lambda r: r / "transforms.json"),
    "minimal dict": ("minimal-parser", tfix.make_minimal_fixture, {}, {}, None),
    "minimal arrays times": ("minimal-parser", tfix.make_minimal_fixture,
                             dict(cameras_as_dict=False, with_times=True), {},
                             None),
    "phototourism": ("phototourism-data", tfix.make_phototourism_fixture,
                     dict(num_images=10), {}, None),
    "phototourism mixed sizes": ("phototourism-data",
                                 tfix.make_phototourism_fixture,
                                 dict(num_images=10, mixed_sizes=True),
                                 dict(scale_factor=1.0, center_method="focus"),
                                 None),
    "phototourism sparse/0": ("phototourism-data",
                              tfix.make_phototourism_fixture,
                              dict(num_images=10), dict(auto_scale_poses=False),
                              _sparse0),
    "dycheck": ("dycheck-data", tfix.make_dycheck_fixture, dict(num_frames=7),
                {}, None),
    "dycheck ds1": ("dycheck-data", tfix.make_dycheck_fixture,
                    dict(num_frames=6, downscale=1), dict(downscale_factor=1),
                    None),
    "sdfstudio": ("sdfstudio-data", tfix.make_sdfstudio_fixture, {}, {}, None),
    "sdfstudio priors": ("sdfstudio-data", tfix.make_sdfstudio_fixture, {},
                         dict(include_mono_prior=True), None),
    "scannet": ("scannet-data", tfix.make_scannet_fixture, {}, {}, None),
    "arkitscenes": ("arkitscenes-data", tfix.make_arkitscenes_fixture, {}, {},
                    None),
}


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    out = {}
    for case, (_, writer, args, _, data) in CASES.items():
        root = writer(tmp_path_factory.mktemp(case.replace(" ", "_").replace(
            "/", "_")), h=H, w=W, **args)
        out[case] = data(root) if data else root
    return out


def _np(x):
    return None if x is None else np.asarray(x.cpu() if torch.is_tensor(x) else x)


def _same_value(got, want, where):
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), where
        for k in want:
            _same_value(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (list, tuple)) or want is None:
        assert got == want, where
    else:
        np.testing.assert_allclose(_np(got), _np(want), atol=TOL, err_msg=where)


def _assert_same_outputs(t, j):
    assert t.image_filenames == j.image_filenames
    for name in ("camera_to_worlds", "fx", "fy", "cx", "cy", "width", "height",
                 "distortion_params", "camera_type", "times", "ids"):
        a, b = _np(getattr(j.cameras, name)), _np(getattr(t.cameras, name))
        if a is None:
            assert b is None, name
            continue
        assert b.shape == a.shape and b.dtype == a.dtype, name
        np.testing.assert_allclose(b, a, atol=TOL, err_msg=name)
    np.testing.assert_allclose(_np(t.scene_box.aabb), _np(j.scene_box.aabb),
                               atol=TOL)
    assert t.dataparser_scale == pytest.approx(j.dataparser_scale, abs=TOL)
    np.testing.assert_allclose(np.asarray(t.dataparser_transform),
                               np.asarray(j.dataparser_transform), atol=TOL)
    assert t.mask_filenames == j.mask_filenames
    assert t.alpha_color is None and j.alpha_color is None
    _same_value(t.metadata, j.metadata, "metadata")


@pytest.mark.parametrize("split", ["train", "val"])
@pytest.mark.parametrize("case", list(CASES))
def test_parser_matches_jax(roots, case, split):
    name, _, _, args, _ = CASES[case]
    data = roots[case]
    j = JAX_PARSERS[name](data=data, **args).setup().get_dataparser_outputs(split)
    t = DATAPARSERS[name](data=data, **args).setup().get_dataparser_outputs(split)
    _assert_same_outputs(t, j)
    assert t.cameras.camera_to_worlds.device.type == "cpu"
    if split == "train":
        assert len(t.image_filenames) >= 6
        # the first image loads at its camera's size
        item = tds.InputDataset(t)[0]
        assert item["image"].shape == (int(t.cameras.height[0]),
                                       int(t.cameras.width[0]), 3)


def test_new_parsers_are_registered_as_in_jax():
    """JAX's names in JAX's order; each new config's fields and defaults
    are JAX's."""
    assert list(DATAPARSERS) == list(JAX_PARSERS)
    for name in NEW:
        cls, jcls = DATAPARSERS[name], JAX_PARSERS[name]
        assert cls.__module__.startswith("soccernerfs_tpu_torch.")
        assert cls.__name__ == jcls.__name__
        assert ([(f.name, f.default) for f in dataclasses.fields(cls)]
                == [(f.name, f.default) for f in dataclasses.fields(jcls)])


@pytest.mark.parametrize("name", NEW)
def test_train_cli_takes_each_new_parser(name, tmp_path):
    """``snt-train nerfacto <name> --data <path> [its flags]`` in both
    packages: the same dataparser config, field by field."""
    flags = {"phototourism-data": ["--scale-factor", "2.0"],
             "dycheck-data": ["--downscale-factor", "1"],
             "sdfstudio-data": ["--include-mono-prior", "True"],
             "nuscenes-data": ["--version", "v1.0-trainval"]}.get(name, [])
    argv = ["nerfacto", name, "--data", str(tmp_path), *flags]
    t = tparse(argv).pipeline.datamanager.dataparser
    j = jparse(argv).pipeline.datamanager.dataparser
    assert type(t).__name__ == type(j).__name__
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.data == tmp_path


def test_nuscenes_refuses_alike(tmp_path, monkeypatch):
    """Without the devkit both exit with the same message; with it both
    raise NotImplementedError."""
    jp = JAX_PARSERS["nuscenes-data"](data=tmp_path).setup()
    tp = DATAPARSERS["nuscenes-data"](data=tmp_path).setup()
    monkeypatch.setitem(sys.modules, "nuscenes", None)
    with pytest.raises(SystemExit) as j:
        jp.get_dataparser_outputs("train")
    with pytest.raises(SystemExit) as t:
        tp.get_dataparser_outputs("train")
    assert str(t.value) == str(j.value) and "nuscenes-devkit" in str(t.value)
    devkit = types.ModuleType("nuscenes")
    devkit.nuscenes = types.ModuleType("nuscenes.nuscenes")
    devkit.nuscenes.NuScenes = object
    monkeypatch.setitem(sys.modules, "nuscenes", devkit)
    monkeypatch.setitem(sys.modules, "nuscenes.nuscenes", devkit.nuscenes)
    for parser in (jp, tp):
        with pytest.raises(NotImplementedError, match="devkit database"):
            parser.get_dataparser_outputs("val")


def test_sdfstudio_splits_are_the_same_frames(roots):
    for split in ("val", "test"):
        for parsers in (DATAPARSERS, JAX_PARSERS):
            p = parsers["sdfstudio-data"](data=roots["sdfstudio"]).setup()
            a = p.get_dataparser_outputs("train")
            b = p.get_dataparser_outputs(split)
            assert a.image_filenames == b.image_filenames
            np.testing.assert_array_equal(_np(a.cameras.camera_to_worlds),
                                          _np(b.cameras.camera_to_worlds))


def test_mixed_image_sizes_are_refused_alike(roots):
    """A phototourism collection of three image sizes parses (each camera
    with its size) and the image caches of both packages refuse to stack
    it, alike; one size stacks."""
    data = roots["phototourism mixed sizes"]
    t = DATAPARSERS["phototourism-data"](data=data).setup()
    j = JAX_PARSERS["phototourism-data"](data=data).setup()
    to, jo = t.get_dataparser_outputs("train"), j.get_dataparser_outputs("train")
    assert len(set(_np(to.cameras.width).tolist())) == 3
    random.seed(3)
    with pytest.raises(ValueError) as je:
        jcache.ImageBatchCache(jds.InputDataset(jo), -1, -1).next_batch()
    with pytest.raises(ValueError) as te:
        tcache.ImageBatchCache(tds.InputDataset(to), -1, -1,
                               rng=random.Random(3)).next_batch()
    assert str(te.value) == str(je.value)
    assert "same shape" in str(te.value)
    one = DATAPARSERS["phototourism-data"](
        data=roots["phototourism"]).setup().get_dataparser_outputs("train")
    batch = tcache.ImageBatchCache(tds.InputDataset(one), -1, -1).next_batch()
    assert batch["image"].shape == (len(one.image_filenames), H, W, 3)


def test_fixture_poses_are_the_ball_scene(roots):
    """Each parser that keeps the scene's frame reads back the fixture's
    ring (instant-ngp recentred and scaled, dycheck and sdfstudio as
    written), so the images are renders of what the cameras see."""
    poses = tfix.ring_poses(8, 0)
    out = DATAPARSERS["sdfstudio-data"](data=roots["sdfstudio"]).setup(
    ).get_dataparser_outputs("train")
    np.testing.assert_allclose(_np(out.cameras.camera_to_worlds),
                               poses[:, :3], atol=1e-6)
    out = DATAPARSERS["instant-ngp-data"](data=roots["instant-ngp"]).setup(
    ).get_dataparser_outputs("train")
    c2w = poses[:, :3].copy()
    c2w[..., 3] = (c2w[..., 3] - c2w[..., 3].mean(0)) * 0.33
    np.testing.assert_allclose(_np(out.cameras.camera_to_worlds), c2w, atol=1e-6)
    assert _np(out.scene_box.aabb).tolist() == [[-2.0] * 3, [2.0] * 3]
    out = DATAPARSERS["dycheck-data"](data=roots["dycheck"]).setup(
    ).get_dataparser_outputs("train")
    rot = _np(out.cameras.camera_to_worlds)[:, :, :3]
    np.testing.assert_allclose(rot @ rot.transpose(0, 2, 1),
                               np.broadcast_to(np.eye(3), rot.shape), atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(
        _np(out.cameras.camera_to_worlds)[:, :2, 3], axis=1), 2.5, atol=1e-5)
    np.testing.assert_allclose(_np(out.cameras.times), np.arange(7) / 6,
                               atol=1e-7)
