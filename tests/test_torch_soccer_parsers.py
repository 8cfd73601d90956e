"""The port's soccer-scene parsers against the JAX package's, scene by
scene: the camera tables, the file-name -> (camera id, time step)
functions, the split selections, and whole parses of small on-disk
layouts of the closeup, stadiumwide, stadium and dynamic scenes (the
broadcaststyle scene is held in tests/test_torch_data_path.py).
"""
import json
import types

import numpy as np
import pytest
import torch

from soccernerfs_tpu.data.dataparsers import soccer as jsoc
from soccernerfs_tpu_torch.data.dataparsers import soccer as tsoc


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch CPU thread while this file runs (the suite runs in
    parallel worker processes, whose default thread pools oversubscribe
    the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(x):
    return None if x is None else np.asarray(x.cpu() if torch.is_tensor(x) else x)


def _assert_same_outputs(j, t):
    assert t.image_filenames == j.image_filenames
    assert t.mask_filenames == j.mask_filenames
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
    assert t.metadata == j.metadata


def _pose(rng):
    """A camera on a sphere of radius 3 looking near the origin."""
    origin = rng.normal(size=3)
    origin = 3.0 * origin / np.linalg.norm(origin)
    forward = rng.normal(scale=0.2, size=3) - origin
    forward /= np.linalg.norm(forward)
    right = np.cross(forward, [0.0, 0.0, 1.0])
    right /= np.linalg.norm(right)
    pose = np.eye(4)
    pose[:3, 0], pose[:3, 1], pose[:3, 2] = right, np.cross(right, forward), -forward
    pose[:3, 3] = origin
    return pose


def _write_scene(root, cams, steps, name, seed, per_frame=False,
                 masks=False, missing=0):
    """transforms.json over ``name(cam, step)`` for every camera and step,
    and an (empty) file for each under ``images/2x/``; the first
    ``missing`` frames are listed without a file.  ``per_frame`` gives
    every frame its own intrinsics and distortion."""
    rng = np.random.default_rng(seed)
    (root / "images" / "2x").mkdir(parents=True, exist_ok=True)
    (root / "masks" / "2x").mkdir(parents=True, exist_ok=True)
    frames = []
    for cam in cams:
        pose = _pose(rng)
        for step in steps:
            fname = name(cam, step)
            frame = {"file_path": f"images/{fname}",
                     "transform_matrix": pose.tolist()}
            if per_frame:
                frame.update(fl_x=float(rng.uniform(600, 900)),
                             fl_y=float(rng.uniform(600, 900)),
                             cx=float(rng.uniform(400, 560)),
                             cy=float(rng.uniform(250, 290)),
                             w=960, h=540, k1=float(rng.normal(scale=0.01)),
                             p2=float(rng.normal(scale=1e-3)))
            if masks:
                frame["mask_path"] = f"masks/{fname}"
                (root / "masks" / "2x" / fname).touch()
            frames.append(frame)
    for frame in frames[missing:]:
        (root / "images" / "2x" / frame["file_path"].split("/", 1)[1]).touch()
    meta = {"frames": frames}
    if not per_frame:
        meta.update(fl_x=800.0, fl_y=810.0, cx=480.0, cy=270.0, w=960, h=540,
                    camera_model="OPENCV", k1=0.01, k2=-0.002, p1=0.0, p2=0.0)
    (root / "transforms.json").write_text(json.dumps(meta))
    return root


def _parse_both(jcfg, tcfg, split):
    j = jcfg.setup().get_dataparser_outputs(split)
    t = tcfg.setup().get_dataparser_outputs(split)
    _assert_same_outputs(j, t)
    return t


# ------------------------------------------------------------------ tables


def test_camera_tables_match_jax():
    assert tsoc.BROADCASTSTYLE_CAM_IDS == jsoc.BROADCASTSTYLE_CAM_IDS
    assert tsoc.CLOSEUP_CAM_IDS == jsoc.CLOSEUP_CAM_IDS
    assert tsoc.SOCCER_SETUPS == jsoc.SOCCER_SETUPS
    assert tsoc.CAMERA_LOCATIONS == jsoc.CAMERA_LOCATIONS
    assert tsoc.CLOSE_CAMERAS == jsoc.CLOSE_CAMERAS
    assert set(tsoc._SCENES) == set(jsoc._SCENES)
    for name, spec in tsoc._SCENES.items():
        jspec = jsoc._SCENES[name]
        assert (spec.name, spec.empty_dir_suffix, spec.one_based_split_ids) == (
            jspec.name, jspec.empty_dir_suffix, jspec.one_based_split_ids)


_NAMES = {
    "broadcaststyle": [f"Camera_{i}_{t:03d}.png" for i in (1, 7, 20) for t in (0, 9)]
    + ["global_1_004.png", "global_8_12.jpg"],
    "closeup": [f"{n}_{t:03d}.png" for n in jsoc.CLOSEUP_CAM_IDS for t in (0, 17)],
    "stadiumwide": [f"{loc}-{i}_{t}.png" for loc in jsoc.CAMERA_LOCATIONS
                    for i in (0, 9) for t in (0, 31)]
    + [f"{n}_{t}.png" for n in jsoc.CLOSE_CAMERAS for t in (2, 40)],
    "dynamic": [f"{c}_{t}.png" for c in (1, 2, 17) for t in (1, 2, 120)]
    + ["3_0004.jpg"],
}
_NAMES["stadium"] = _NAMES["stadiumwide"]


@pytest.mark.parametrize("scene", sorted(_NAMES))
def test_frame_metadata_matches_jax(scene):
    """Every scene's file name -> (camera id, time step), the dynamic
    scene's 1-based steps included."""
    tf, jf = tsoc._SCENES[scene].frame_metadata, jsoc._SCENES[scene].frame_metadata
    got = [tf(n) for n in _NAMES[scene]]
    assert got == [jf(n) for n in _NAMES[scene]]
    assert all(type(c) is int and type(s) is int for c, s in got)
    if scene == "dynamic":
        assert got[0] == (1, 0)


@pytest.mark.parametrize("setup", sorted(jsoc.SOCCER_SETUPS))
@pytest.mark.parametrize("scene", ["broadcaststyle", "closeup"])
def test_setup_split_selection_matches_jax(scene, setup):
    """The named setups' train/eval camera ids and their prefilter; a setup
    naming cameras a scene lacks raises in both."""
    cfg = types.SimpleNamespace(cam_split_setup=setup)
    for split in ("train", "val", "test"):
        try:
            want = jsoc._SCENES[scene].select_cams(cfg, split, None)
        except ValueError:
            with pytest.raises(ValueError, match="absent"):
                tsoc._SCENES[scene].select_cams(cfg, split, None)
            continue
        assert tsoc._SCENES[scene].select_cams(cfg, split, None) == want


@pytest.mark.parametrize("nb,closeup_training", [(110, False), (37, True), (5, False)])
def test_stadiumwide_selection_matches_jax(nb, closeup_training):
    cfg = types.SimpleNamespace(nb_train_cameras=nb, closeup_training=closeup_training)
    for split in ("train", "val"):
        assert (tsoc._stadiumwide_select(cfg, split, None)
                == jsoc._stadiumwide_select(cfg, split, None))


@pytest.mark.parametrize("one_based", [False, True])
@pytest.mark.parametrize("pct", [1.0, 0.95, 0.5, 0.1])
def test_percentage_selection_matches_jax(pct, one_based):
    """The equally spaced split over unique camera ids, with the dynamic
    scene's +1."""
    cfg = types.SimpleNamespace(train_split_percentage=pct, _one_based=one_based)
    uids = [4, 4, 0, 1, 2, 3, 5, 6, 7, 8, 9, 10, 11, 12, 12]
    for split in ("train", "val", "test", "eval"):
        assert (tsoc._percentage_select(cfg, split, uids)
                == jsoc._percentage_select(cfg, split, uids))
    assert tsoc._percentage_select(cfg, "train", None) == ([], None)
    with pytest.raises(ValueError):
        tsoc._percentage_select(cfg, "other", uids)


# ----------------------------------------------------------- whole parses


@pytest.fixture(scope="module")
def closeup_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("closeup") / "closeup"
    name = lambda cam, step: f"{cam}_{step:03d}.png"  # noqa: E731
    _write_scene(root, list(jsoc.CLOSEUP_CAM_IDS), range(6), name, seed=1,
                 masks=True, missing=3)
    # the static empty-field mode reads the sibling closeup_empty scene
    _write_scene(root.parent / "closeup_empty", list(jsoc.CLOSEUP_CAM_IDS),
                 range(1), name, seed=2)
    return root


@pytest.mark.parametrize("split", ["train", "val"])
@pytest.mark.parametrize("overrides", [
    {},
    {"cam_split_setup": "real", "fps_downsample": 1.0},
    {"cam_split_setup": "real+opp", "fps_downsample": 2.0, "cap_box_floor": True},
    {"cam_split_setup": "low", "orientation_method": "pca", "center_method": "poses"},
    {"cam_split_setup": "global", "orientation_method": "up",
     "center_method": "focus", "auto_scale_poses": False, "scale_factor": 0.5},
    {"static": True, "static_timestep": 4, "fps_downsample": 1.0},
    {"static": True, "static_timestep": 2, "static_allimgs": True},
    {"static": True, "fps_downsample": 1.0},
], ids=["zoom", "real", "real+opp", "low", "global", "static-4",
        "static-allimgs", "static-empty"])
def test_closeup_parser_matches_jax(closeup_root, split, overrides):
    t = _parse_both(jsoc.CloseupDataParserConfig(data=closeup_root, **overrides),
                    tsoc.CloseupDataParserConfig(data=closeup_root, **overrides),
                    split)
    if overrides.get("static") and "static_timestep" not in overrides:
        assert all(f.parent.parent.parent.name == "closeup_empty"
                   for f in t.image_filenames)


@pytest.fixture(scope="module")
def stadium_root(tmp_path_factory):
    """Every bleacher camera and the six close cameras, 3 steps, with
    per-frame intrinsics and distortion."""
    root = tmp_path_factory.mktemp("stadium") / "stadium"
    cams = [f"{loc}-{i}" for loc in jsoc.CAMERA_LOCATIONS for i in range(10)]
    _write_scene(root, cams + list(jsoc.CLOSE_CAMERAS), range(3),
                 lambda cam, step: f"{cam}_{step}.png", seed=3, per_frame=True,
                 missing=5)
    return root


@pytest.mark.parametrize("split", ["train", "val"])
@pytest.mark.parametrize("overrides", [
    {},
    {"nb_train_cameras": 12, "closeup_training": True},
    {"nb_train_cameras": 40, "fps_downsample": 1.5, "cap_box_floor": True},
], ids=["110", "12+close", "40-fps"])
def test_stadiumwide_parser_matches_jax(stadium_root, split, overrides):
    t = _parse_both(jsoc.StadiumwideDataParserConfig(data=stadium_root, **overrides),
                    tsoc.StadiumwideDataParserConfig(data=stadium_root, **overrides),
                    split)
    if split == "val":
        assert set(_np(t.cameras.ids).tolist()) == set(range(110, 116))


@pytest.mark.parametrize("split", ["train", "val"])
@pytest.mark.parametrize("overrides", [
    {"train_split_percentage": 0.5},
    {"train_split_percentage": 0.3, "apply_camera_location_filter": True,
     "camera_location": "Ext Left-Left"},
    {"train_split_percentage": 0.5, "orientation_method": "none",
     "center_method": "none", "depth_unit_scale_factor": 0.01},
], ids=["half", "location", "no-orient"])
def test_stadium_parser_matches_jax(stadium_root, split, overrides):
    t = _parse_both(jsoc.StadiumDataParserConfig(data=stadium_root, **overrides),
                    tsoc.StadiumDataParserConfig(data=stadium_root, **overrides),
                    split)
    if overrides.get("apply_camera_location_filter"):
        assert all(f.name.startswith("Ext Left-Left-") for f in t.image_filenames)


@pytest.fixture(scope="module")
def dynamic_root(tmp_path_factory):
    """Cameras 1..8 (the dynamic scene's ids are 1-based), steps 1..4."""
    root = tmp_path_factory.mktemp("dynamic") / "dynamic"
    _write_scene(root, range(1, 9), range(1, 5),
                 lambda cam, step: f"{cam}_{step}.png", seed=4)
    return root


@pytest.mark.parametrize("split,pct", [("train", 1.0), ("train", 0.75),
                                       ("val", 0.75), ("test", 0.5)])
def test_dynamic_parser_matches_jax(dynamic_root, split, pct):
    t = _parse_both(jsoc.DynamicDataParserConfig(data=dynamic_root,
                                                 train_split_percentage=pct),
                    tsoc.DynamicDataParserConfig(data=dynamic_root,
                                                 train_split_percentage=pct),
                    split)
    ids = set(_np(t.cameras.ids).tolist())
    assert ids <= set(range(1, 9))
    if split == "train":
        assert 1 in ids and 8 in ids  # the +1: ids 1 and 8 are the ends


def test_parsers_refuse_alike(dynamic_root, tmp_path):
    """Where the JAX parser asserts, the port raises: an eval split that
    selects nothing, a scene without its images, a setup naming absent
    cameras."""
    cases = [
        (jsoc.DynamicDataParserConfig(data=dynamic_root),
         tsoc.DynamicDataParserConfig(data=dynamic_root), "val"),
        (jsoc.DynamicDataParserConfig(data=dynamic_root, downscale_factor=4),
         tsoc.DynamicDataParserConfig(data=dynamic_root, downscale_factor=4), "train"),
    ]
    broadcast = _write_scene(tmp_path / "b", ["Camera_1", "Camera_20"], range(2),
                             lambda cam, step: f"{cam}_{step:03d}.png", seed=5)
    cases.append((jsoc.BroadcaststyleDataParserConfig(data=broadcast,
                                                      cam_split_setup="real"),
                  tsoc.BroadcaststyleDataParserConfig(data=broadcast,
                                                      cam_split_setup="real"),
                  "train"))
    for jcfg, tcfg, split in cases:
        with pytest.raises((AssertionError, ValueError)):
            jcfg.setup().get_dataparser_outputs(split)
        with pytest.raises((ValueError, FileNotFoundError)):
            tcfg.setup().get_dataparser_outputs(split)
