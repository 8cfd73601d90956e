"""The COLMAP readers and ``snt-process-data`` of the port against the JAX
package's.

The readers (binary and text; SIMPLE_PINHOLE, PINHOLE, SIMPLE_RADIAL and
OPENCV cameras) and ``colmap_to_transforms`` equal JAX's on the port's
COLMAP fixture; ``colmap-to-json`` and the polycam, record3d, metashape and
realitycapture converters write the same ``transforms.json`` and images
(their inputs built as ``tests/test_capture_converters.py`` builds them);
the insta360 ffmpeg commands are equal; ``images --skip-colmap`` over an
equirectangular panorama writes the same crops; ``--downscale`` writes the
same ``2x`` images; the exits without COLMAP, ffmpeg or hloc say the same
apart from the package's name; every subcommand's help is JAX's.  Then the
path as a user runs it: a COLMAP capture through each package's
``colmap-to-json`` and ``nerfstudio-data`` gives the same first train
batch with the same draws, and the parsed poses are the capture's, after
the parser's orientation and scale.
"""
import contextlib
import io
import json
import random
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from soccernerfs_tpu.data import colmap_utils as jcu
from soccernerfs_tpu.data import native_loader
from soccernerfs_tpu.data.datamanager import VanillaDataManagerConfig as JVanilla
from soccernerfs_tpu.data.dataparsers.nerfstudio_parser import (
    NerfstudioDataParserConfig as JNerfstudio,
)
from soccernerfs_tpu.scripts import capture_converters as jcc
from soccernerfs_tpu.scripts import process_data as jpd
from soccernerfs_tpu.scripts import sfm_tools as jst
from soccernerfs_tpu_torch.data import colmap_utils as tcu
from soccernerfs_tpu_torch.data import fixtures as tfix
from soccernerfs_tpu_torch.data.datamanager import VanillaDataManagerConfig as TVanilla
from soccernerfs_tpu_torch.data.dataparsers.nerfstudio import (
    NerfstudioDataParserConfig as TNerfstudio,
)
from soccernerfs_tpu_torch.scripts import capture_converters as tcc
from soccernerfs_tpu_torch.scripts import process_data as tpd
from soccernerfs_tpu_torch.scripts import sfm_tools as tst

SUBCOMMANDS = ("images", "video", "colmap-to-json", "polycam", "record3d",
               "metashape", "realitycapture", "insta360")


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
def colmap_roots(tmp_path_factory):
    return {binary: tfix.make_colmap_fixture(
        tmp_path_factory.mktemp(f"colmap_{binary}"), num_frames=10, h=12, w=16,
        binary=binary, seed=3) for binary in (True, False)}


def _files(root: Path) -> dict:
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


# ---------------------------------------------------------------------------
# the readers
# ---------------------------------------------------------------------------

def test_qvec2rotmat_matches_jax():
    rng = np.random.default_rng(0)
    for q in rng.normal(size=(16, 4)):
        q /= np.linalg.norm(q)
        np.testing.assert_array_equal(tcu.qvec2rotmat(q), jcu.qvec2rotmat(q))
    assert tcu.CAMERA_MODELS == jcu.CAMERA_MODELS


@pytest.mark.parametrize("binary", [True, False])
def test_readers_match_jax(colmap_roots, binary):
    """Every camera model's parameters, every image's pose, camera, name
    and 2-D points, equal to JAX's readers' (both formats)."""
    sparse = colmap_roots[binary] / "sparse" / "0"
    ext = "bin" if binary else "txt"
    kind = "binary" if binary else "text"
    tcams = getattr(tcu, f"read_cameras_{kind}")(sparse / f"cameras.{ext}")
    jcams = getattr(jcu, f"read_cameras_{kind}")(sparse / f"cameras.{ext}")
    assert [c.model for c in tcams.values()] == list(tfix.COLMAP_FIXTURE_MODELS)
    assert tcams.keys() == jcams.keys()
    for k in jcams:
        t, j = tcams[k], jcams[k]
        assert (t.id, t.model, t.width, t.height) == (j.id, j.model, j.width,
                                                       j.height)
        np.testing.assert_array_equal(t.params, j.params)
        assert len(t.params) == dict(jcu.CAMERA_MODELS.values())[t.model]
    timgs = getattr(tcu, f"read_images_{kind}")(sparse / f"images.{ext}")
    jimgs = getattr(jcu, f"read_images_{kind}")(sparse / f"images.{ext}")
    assert timgs.keys() == jimgs.keys() and len(timgs) == 10
    for k in jimgs:
        t, j = timgs[k], jimgs[k]
        assert (t.id, t.camera_id, t.name) == (j.id, j.camera_id, j.name)
        for f in ("qvec", "tvec", "xys", "point3d_ids"):
            np.testing.assert_array_equal(getattr(t, f), getattr(j, f), f)
        assert t.point3d_ids.dtype == np.int64 and len(t.xys) >= 1
    tm, jm = tcu.read_model(sparse), jcu.read_model(sparse)
    assert [c.params.tolist() for c in tm[0].values()] == [
        c.params.tolist() for c in jm[0].values()]
    if binary:
        for a, b in zip(tcu.read_points3d_binary(sparse / "points3D.bin"),
                        jcu.read_points3d_binary(sparse / "points3D.bin")):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("binary", [True, False])
def test_colmap_to_transforms_matches_jax(colmap_roots, binary):
    """The same dict, and the ring's camera-to-worlds back (the fixture
    undoes the world change) with each camera model's distortion keys."""
    sparse = colmap_roots[binary] / "sparse" / "0"
    t = tcu.colmap_to_transforms(sparse)
    assert t == jcu.colmap_to_transforms(sparse)
    poses = np.array([f["transform_matrix"] for f in t["frames"]])
    np.testing.assert_allclose(poses, tfix.ring_poses(10, 3), atol=1e-12)
    keys = [sorted(k for k in f if k in ("k1", "k2", "p1", "p2"))
            for f in t["frames"][:4]]
    assert keys == [[], [], ["k1"], ["k1", "k2", "p1", "p2"]]
    assert t["frames"][3]["k1"] != 0 and t["frames"][3]["p2"] != 0


# ---------------------------------------------------------------------------
# snt-process-data
# ---------------------------------------------------------------------------

def _run_both(tmp_path, argv_of, prepare=None):
    """Run JAX's and the port's main on their own copies of the inputs;
    the two output directories."""
    outs = []
    for name, main in (("jax", jpd.main), ("port", tpd.main)):
        work = tmp_path / name
        work.mkdir()
        if prepare:
            prepare(work)
        out = work / "out"
        with contextlib.redirect_stdout(io.StringIO()):
            main(argv_of(work, out))
        outs.append(out)
    return outs


def test_colmap_to_json_matches_jax(tmp_path, colmap_roots):
    root = colmap_roots[True]
    j, t = _run_both(tmp_path, lambda work, out: [
        "colmap-to-json", "--sparse", str(root / "sparse" / "0"),
        "--output-dir", str(out)])
    assert _files(t) == _files(j)
    assert len(json.loads((t / "transforms.json").read_text())["frames"]) == 10


def _png(path, w=8, h=6, value=0):
    Image.fromarray(np.full((h, w, 3), value, np.uint8)).save(path)


def _polycam(work):
    kf = work / "cap" / "keyframes"
    (kf / "images").mkdir(parents=True)
    (kf / "cameras").mkdir()
    for i, blur in enumerate([100.0, 5.0, 60.0]):
        _png(kf / "images" / f"{i}.jpg", value=40 * i)
        (kf / "cameras" / f"{i}.json").write_text(json.dumps({
            "fx": 100.0, "fy": 101.0, "cx": 4.0, "cy": 3.0,
            "width": 8, "height": 6, "blur_score": blur,
            **{f"t_{r}{c}": float(r * 4 + c + i) for r in range(3)
               for c in range(4)}}))


def _record3d(work):
    cap = work / "cap"
    (cap / "rgb").mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i in range(5):
        _png(cap / "rgb" / f"{i}.jpg", value=30 * i)
    q = rng.normal(size=(5, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    poses = np.concatenate([q, rng.normal(size=(5, 3))], axis=1)
    k = np.array([[50, 0, 0], [0, 50, 0], [4, 3, 1]], float)
    (cap / "metadata.json").write_text(json.dumps({
        "poses": poses.tolist(), "K": k.reshape(-1).tolist(), "w": 8, "h": 6}))


def _metashape(work):
    imgs = work / "imgs"
    imgs.mkdir()
    _png(imgs / "cam0.png")
    _png(imgs / "cam1.png", value=9)
    t = " ".join(str(float(v)) for v in range(16))
    (work / "cameras.xml").write_text(f"""<document><chunk>
      <sensors><sensor id="0"><resolution width="8" height="6"/>
        <calibration><f>100</f><cx>0.5</cx><cy>-0.5</cy><k1>0.01</k1></calibration>
      </sensor></sensors>
      <cameras>
        <camera label="cam0.png" sensor_id="0"><transform>{t}</transform></camera>
        <camera label="cam1.png" sensor_id="0"/>
      </cameras>
    </chunk></document>""")


def _realitycapture(work):
    imgs = work / "imgs"
    imgs.mkdir()
    _png(imgs / "shot0.png")
    _png(imgs / "shot1.png", value=7)
    (work / "poses.csv").write_text(
        "#name,x,y,alt,heading,pitch,roll,f,px,py,k1,k2,k3,k4,t1,t2\n"
        "shot0.png,1.0,2.0,3.0,10,20,30,36,0.5,-0.5,0.01,0,0,0,0,0\n"
        "shot1.png,0.5,-2.0,1.0,-40,5,2,24,0,0,0,0.02,0,0,0.001,0\n"
        "missing.png,0,0,0,0,0,0,36,0,0,0,0,0,0,0,0\n")


CONVERTERS = {
    "polycam": (_polycam, lambda w: ["--data", str(w / "cap"),
                                     "--crop-border-pixels", "1"]),
    "record3d": (_record3d, lambda w: ["--data", str(w / "cap"),
                                       "--max-dataset-size", "3"]),
    "metashape": (_metashape, lambda w: ["--data", str(w / "imgs"), "--xml",
                                         str(w / "cameras.xml")]),
    "realitycapture": (_realitycapture, lambda w: ["--data", str(w / "imgs"),
                                                   "--csv", str(w / "poses.csv")]),
}


@pytest.mark.parametrize("cmd", list(CONVERTERS))
def test_capture_converters_match_jax(tmp_path, cmd):
    """The same transforms.json (the inputs' paths aside, there are none in
    it) and the same copied images."""
    prepare, args = CONVERTERS[cmd]
    j, t = _run_both(tmp_path, lambda work, out: [cmd, *args(work),
                                                  "--output-dir", str(out)],
                     prepare)
    assert _files(t) == _files(j)
    meta = json.loads((t / "transforms.json").read_text())
    assert meta["frames"] and len(list((t / "images").iterdir())) >= 1


def test_insta360_commands_match_jax(tmp_path, monkeypatch):
    for back in (Path("a_10_x.insv"), None):
        for n in (10, 300):
            assert (tcc.insta360_ffmpeg_commands(Path("a_00_x.insv"), back,
                                                 "imgs", n, 0.6)
                    == jcc.insta360_ffmpeg_commands(Path("a_00_x.insv"), back,
                                                    "imgs", n, 0.6))
    # without ffmpeg, or without a video, both exit alike
    monkeypatch.setattr(shutil, "which", lambda name: None)
    (tmp_path / "v").mkdir()
    (tmp_path / "v" / "a_00_x.insv").write_bytes(b"")
    for data in (tmp_path / "v", tmp_path / "empty"):
        (tmp_path / "empty").mkdir(exist_ok=True)
        with pytest.raises(SystemExit) as j:
            jcc.convert_insta360(data, tmp_path / "j")
        with pytest.raises(SystemExit) as t:
            tcc.convert_insta360(data, tmp_path / "t")
        assert str(t.value) == str(j.value)


def test_equirect_images_match_jax(tmp_path):
    """``images --skip-colmap --camera-type equirectangular`` on a seeded
    panorama: the same 8 crops, of the size JAX's resolution rule picks,
    and the same copies under images/."""
    def prepare(work):
        tfix.make_equirect_panorama(work / "raw" / "pano.png", 64, 128, seed=1)

    j, t = _run_both(tmp_path, lambda work, out: [
        "images", "--data", str(work / "raw"), "--output-dir", str(out),
        "--skip-colmap", "--camera-type", "equirectangular"], prepare)
    assert _files(t) == _files(j)
    crops = sorted((t / "images").iterdir())
    assert len(crops) == 8
    assert {Image.open(p).size for p in crops} == {(32, 32)}
    assert _files(t.parent / "raw") == _files(j.parent / "raw")
    # the views themselves
    assert tst.equirect_view_directions(14, (0.1, 0.2, 0.0, 0.3)) == \
        jst.equirect_view_directions(14, (0.1, 0.2, 0.0, 0.3))
    pano = np.asarray(Image.open(t.parent / "raw" / "pano.png"))
    for yaw, pitch in ((0.0, 10.0), (170.0, -45.0)):
        np.testing.assert_array_equal(
            tst.equirect_to_perspective(pano, 100.0, yaw, pitch, (9, 11)),
            jst.equirect_to_perspective(pano, 100.0, yaw, pitch, (9, 11)))


def test_downscale_matches_jax(tmp_path):
    """``--downscale 2`` runs the repository's downsample script: the same
    2x images (the port launches it with this interpreter)."""
    def prepare(work):
        (work / "raw").mkdir()
        for i in range(2):
            _png(work / "raw" / f"{i}.png", w=10, h=6, value=50 * i)

    j, t = _run_both(tmp_path, lambda work, out: [
        "images", "--data", str(work / "raw"), "--output-dir", str(out),
        "--skip-colmap", "--downscale", "2"], prepare)
    assert _files(t) == _files(j)
    assert sorted(p.name for p in (t / "images" / "2x").iterdir()) == [
        "frame_00000.png", "frame_00001.png"]
    assert Image.open(t / "images" / "2x" / "frame_00001.png").size == (5, 3)


def test_missing_tools_exit_alike(tmp_path, monkeypatch):
    """No COLMAP, ffmpeg or hloc: the same exits and errors, the port's
    naming its own module."""
    monkeypatch.setattr(shutil, "which", lambda name: None)
    (tmp_path / "raw").mkdir()
    _png(tmp_path / "raw" / "a.png")
    cases = [
        (["images", "--data", str(tmp_path / "raw")], SystemExit),
        (["video", "--data", str(tmp_path / "v.mp4")], SystemExit),
        (["images", "--data", str(tmp_path / "raw"), "--sfm-tool", "hloc"],
         RuntimeError),
    ]
    port = []
    for argv, error in cases:
        msgs = []
        for main in (jpd.main, tpd.main):
            with pytest.raises(error) as e, \
                    contextlib.redirect_stdout(io.StringIO()):
                main([*argv, "--output-dir", str(tmp_path / "out")])
            msgs.append(str(e.value))
        assert msgs[1] == msgs[0].replace("soccernerfs_tpu.", "soccernerfs_tpu_torch.")
        port.append(msgs[1])
    assert ("python -m soccernerfs_tpu_torch.scripts.process_data colmap-to-json"
            in port[0])
    assert "ffmpeg is not installed" in port[1] and "hloc" in port[2]


@pytest.mark.parametrize("cmd", [None, *SUBCOMMANDS])
def test_help_matches_jax(cmd, capsys):
    """Every subcommand with JAX's arguments and defaults: the same help."""
    argv = ["--help"] if cmd is None else [cmd, "--help"]
    texts = []
    for main in (jpd.main, tpd.main):
        with pytest.raises(SystemExit) as e:
            main(argv)
        assert e.value.code == 0
        texts.append(capsys.readouterr().out)
    assert texts[1] == texts[0]
    if cmd is None:
        assert all(name in texts[1] for name in SUBCOMMANDS)


# ---------------------------------------------------------------------------
# a user's capture to the first train batch
# ---------------------------------------------------------------------------

def test_capture_to_first_train_batch_matches_jax(tmp_path):
    """A COLMAP capture (one OPENCV camera with small distortions) through
    each package's ``colmap-to-json`` and ``nerfstudio-data``: the poses
    read back are the capture's after the parser's orientation and scale
    (1e-5), the distortion reaches the cameras, and the first train batch
    with the same draws has the same indices, rgb and rays."""
    data = {}
    for name, main in (("jax", jpd.main), ("port", tpd.main)):
        root = tfix.make_colmap_fixture(tmp_path / name, num_frames=12, h=12,
                                        w=16, camera_models=("OPENCV",), seed=5)
        with contextlib.redirect_stdout(io.StringIO()):
            main(["colmap-to-json", "--sparse", str(root / "sparse" / "0"),
                  "--output-dir", str(root)])
        data[name] = root
    assert _files(data["port"]) == _files(data["jax"])

    outputs = TNerfstudio(data=data["port"]).setup().get_dataparser_outputs("train")
    ring = tfix.ring_poses(12, 5)
    transform = np.concatenate([np.asarray(outputs.dataparser_transform),
                                [[0, 0, 0, 1]]], axis=0)
    want = transform @ ring
    want[:, :3, 3] *= outputs.dataparser_scale
    np.testing.assert_allclose(outputs.cameras.camera_to_worlds.numpy(),
                               want[np.linspace(0, 11, 11, dtype=int), :3],
                               atol=1e-5)
    frames = json.loads((data["port"] / "transforms.json").read_text())["frames"]
    dist = outputs.cameras.distortion_params.numpy()
    np.testing.assert_allclose(dist[0], np.array(
        [frames[0][k] if k in frames[0] else 0.0
         for k in ("k1", "k2", "k3", "k4", "p1", "p2")], np.float32))
    assert np.abs(dist[:, [0, 1, 4, 5]]).min() > 0

    common = dict(train_num_rays_per_batch=64, eval_num_rays_per_batch=32,
                  train_num_images_to_sample_from=4,
                  train_num_times_to_repeat_images=2)
    random.seed(5)
    j = JVanilla(dataparser=JNerfstudio(data=data["jax"]), **common).setup(seed=5)
    t = TVanilla(dataparser=TNerfstudio(data=data["port"]), **common).setup(
        seed=5, device="cpu")
    for step in range(3):
        a, b = j.next_train_raw(step), t.next_train_raw(step)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    rays, batch = t.next_train(3)
    jrays, jbatch = j.next_train(3)
    np.testing.assert_array_equal(batch["indices"], jbatch["indices"])
    np.testing.assert_array_equal(batch["image"], np.asarray(jbatch["image"]))
    np.testing.assert_allclose(rays.origins.numpy(), np.asarray(jrays.origins),
                               atol=1e-6)
    np.testing.assert_allclose(rays.directions.numpy(),
                               np.asarray(jrays.directions), atol=1e-6)
