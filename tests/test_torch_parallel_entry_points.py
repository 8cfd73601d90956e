"""``snt-render``, ``snt-export`` and the viewer over several ranks on the
CPU (gloo), the entry points that the JAX package renders through its
Trainer's sharded ``render_camera`` (a ``shard_map`` over the data mesh).

The run is ``tests/test_torch_parallel_cli.py``'s tiny k-planes-static,
trained at world size 2, so its ``config.yml`` names two devices: each
entry point's ``main`` spawns two ranks (rank 0 in this process), and at
world size 1 (``mesh.local_world_size`` patched to 1) runs in this
process alone.  One spawned pair (``torch_parallel_ranks.entry_points_job``)
runs every entry point inside its group with spies on each rank (the
renders, the density volume, the trajectory's cameras, file writes).

- (a) snt-render: the frames at world size 2 equal world 1's; both ranks
  build the same cameras and render every frame; rank 1 returns None and
  writes nothing.
- (b) the pair's ``render_camera`` of a spiral camera against the JAX
  Trainer's over the conftest's eight host devices, on its params carried
  by ``convert.py``: 1e-5, as tests/test_torch_render_slice.py holds a
  render to JAX's.
- (c) the five snt-export subcommands: files from rank 0 alone, the
  density volume and the rendered depth maps equal world 1's, the PLYs
  and ``cameras.json`` byte-equal.
- (d) the standalone viewer: /render and a path job answered, rank 1
  following every render, the PNG equal to world 1's; a cancelled path
  job and the shutdown leave no rank waiting.
- (e) the live viewer of ``snt-train --vis viewer``: a render between
  steps over both ranks; the final state bit-equal to a run without the
  viewer, which broadcasts nothing.
- (f) a rank whose render raises fails snt-render and the viewer within
  the spawn's timeout.
"""
import copy
import dataclasses
import io
import time

import numpy as np
import pytest
import torch
from PIL import Image

import jax

from soccernerfs_tpu.configs.method_configs import method_configs
from soccernerfs_tpu.core.camera_paths import get_spiral_path as jax_spiral_path
from soccernerfs_tpu.data.dataparsers.blender import BlenderDataParserConfig
from soccernerfs_tpu.engine.trainer import Trainer as JaxTrainer
from soccernerfs_tpu_torch.configs import method_configs as tmc
from soccernerfs_tpu_torch.data.fixtures import make_blender_fixture
from soccernerfs_tpu_torch.parallel import mesh
from soccernerfs_tpu_torch.scripts import exporter
from soccernerfs_tpu_torch.scripts import render as render_script
from soccernerfs_tpu_torch.scripts import train as train_script
from soccernerfs_tpu_torch.viewer import server as viewer
from test_torch_parallel_cli import FLAGS, JOIN_S, _argv
import torch_parallel_ranks as ranks

# the model of FLAGS, for the JAX Trainer and the port's config
MODEL = {"spacetime_resolution": (8, 8, 8), "multiscale_res": (1, 2),
         "feature_dim": 4, "num_proposal_samples_per_ray": (8, 6),
         "num_nerf_samples_per_ray": 4, "sigma_net_hidden_dim": 16,
         "rgb_net_hidden_dim": 16, "eval_num_rays_per_chunk": 128}
RENDER_KEYS = ("rgb", "depth", "accumulation")
EXPORTS = {"pointcloud": ["--num-cameras", "2", "--downsample", "1"],
           "cameras": [],
           "marching-cubes": ["--resolution", "12", "--iso-level", "0.5"],
           "tsdf": ["--resolution", "12", "--num-cameras", "2"],
           "poisson": ["--resolution", "16", "--num-cameras", "2",
                       "--downsample", "1"]}
# (f): a failing rank's command ends within this (its collectives' timeout)
FAIL_TIMEOUT_S = 60


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch CPU thread while this file runs, and so in every rank it
    spawns."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(root, data, config.yml) of a k-planes-static run trained at world
    size 2."""
    root = tmp_path_factory.mktemp("entry_points")
    data = make_blender_fixture(root / "data")
    trainer = train_script.main(
        _argv(root / "out", data, "--machine.num-devices", "2"), device="cpu")
    return root, data, trainer.base_dir / "config.yml"


def _render_argv(config, out):
    return ["--load-config", str(config), "--traj", "spiral",
            "--interpolation-steps", "2", "--output-format", "images",
            "--rendered-output-names", "rgb", "depth", "accumulation",
            "--output-path", str(out / "render.mp4")]


def _export_argv(config, out):
    return {cmd: [cmd, "--load-config", str(config), "--output-dir",
                  str(out / cmd), *extra] for cmd, extra in EXPORTS.items()}


def _viewer_argv(config):
    return ["--load-config", str(config), "--port", "0"]


def _jax_render(root, data):
    """(the port's config, JAX's params, aabb and spiral camera 0 as host
    arrays, JAX's render of it) of a JAX k-planes-static Trainer at FLAGS'
    widths on ``data``, over every conftest device."""
    cfg = copy.deepcopy(method_configs["k-planes-static"])
    cfg.vis = "terminal"
    cfg.output_dir = root / "jax"
    cfg.pipeline.model = dataclasses.replace(cfg.pipeline.model, **MODEL)
    cfg.pipeline.datamanager.dataparser = BlenderDataParserConfig(data=data)
    cfg.set_timestamp()
    jt = JaxTrainer(cfg).setup()
    assert jt._eval_n_dev == len(jax.devices()) == 8
    cams = jax_spiral_path(jt.eval_cameras, steps=2)
    want = jt.render_camera(cams, 0)
    camera = {f.name: np.asarray(getattr(cams, f.name))[:1]
              for f in dataclasses.fields(cams)
              if getattr(cams, f.name) is not None}
    tcfg = dataclasses.replace(tmc.model_configs["k-planes-static"], **MODEL)
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(jt.state.params))
    return tcfg, params, np.asarray(jt.aabb), camera, want


@pytest.fixture(scope="module")
def pair(run):
    """Every entry point on one spawned pair (``entry_points_job``): both
    ranks' results, the JAX render, and the job."""
    root, data, config = run
    cfg, params, aabb, camera, jax_want = _jax_render(root, data)
    out = root / "pair"
    live = [(_argv(root / "live", data, "--vis", "viewer",
                   "--viewer.websocket-port", "0", timestamp="served"), True),
            (_argv(root / "live", data, timestamp="unserved"), False)]
    job = {"render_argv": _render_argv(config, out),
           "export_argv": _export_argv(config, out),
           "viewer_argv": _viewer_argv(config), "live": live,
           "cfg": cfg, "params": params, "aabb": aabb, "camera": camera}
    results = mesh.spawn(ranks.entry_points_job, 2, (job,),
                         devices=["cpu", "cpu"], timeout_s=JOIN_S)
    return results, jax_want, job


def _pngs(directory):
    return [np.asarray(Image.open(p)) for p in sorted(directory.glob("*.png"))]


# ---------------------------------------------------------------------------
# (a) snt-render
# ---------------------------------------------------------------------------

def test_render_at_world_two_equals_world_one(run, tmp_path, monkeypatch):
    _, _, config = run
    written = render_script.main(_render_argv(config, tmp_path / "two"),
                                 device="cpu")
    assert not mesh.current_world()
    two = _pngs(written)
    with monkeypatch.context() as m:
        m.setattr(mesh, "local_world_size", lambda n, device_type: 1)
        one = _pngs(render_script.main(_render_argv(config, tmp_path / "one"),
                                       device="cpu"))
    assert len(two) == len(one) == 2 and two[0].shape == (20, 60, 3)
    for a, b in zip(two, one):
        np.testing.assert_array_equal(a, b)
    assert [p.name for p in (tmp_path / "two").iterdir()] == ["render"]


def test_render_ranks_build_the_same_cameras_and_rank_one_writes_nothing(pair):
    results, _, _ = pair
    mine, other = (r["render"] for r in results)
    assert mine["value"].is_dir() and other["value"] is None
    assert other["writes"] == []
    assert len(mine["writes"]) == 2
    (cams0,), (cams1,) = mine["trajectories"], other["trajectories"]
    assert len(cams0) == len(cams1) == 2
    for a, b in zip(cams0, cams1):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    # both ranks render every frame and get the whole image
    assert len(mine["renders"]) == len(other["renders"]) == 2
    for (_, a), (_, b) in zip(mine["renders"], other["renders"]):
        for k in RENDER_KEYS:
            np.testing.assert_array_equal(a[k], b[k])


# ---------------------------------------------------------------------------
# (b) the port's two-rank render against JAX's sharded render
# ---------------------------------------------------------------------------

def test_two_rank_render_matches_jax_sharded_render(pair):
    results, want, _ = pair
    for r in results:
        got = r["jax_render"]
        for k in RENDER_KEYS:
            assert got[k].shape == np.asarray(want[k]).shape, k
            np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=1e-5,
                                       err_msg=k)
    assert float(np.asarray(want["accumulation"]).max()) > 0.05


# ---------------------------------------------------------------------------
# (c) snt-export
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def exports_one(run, tmp_path_factory):
    """The five subcommands at world size 1 in this process, with the
    spies: {cmd: (file, renders, volumes)}."""
    _, _, config = run
    out = tmp_path_factory.mktemp("exports_one")
    mp = pytest.MonkeyPatch()
    mp.setattr(mesh, "local_world_size", lambda n, device_type: 1)
    rec = ranks._Recorder()
    got = {}
    try:
        for cmd, argv in _export_argv(config, out).items():
            for seen in (rec.renders, rec.volumes):
                seen.clear()
            path = exporter.main(argv, device="cpu")
            got[cmd] = (path, rec.renders[:], rec.volumes[:])
    finally:
        rec.restore()
        mp.undo()
    return got


@pytest.mark.parametrize("cmd", sorted(EXPORTS))
def test_export_at_world_two_equals_world_one(pair, exports_one, cmd):
    results, _, _ = pair
    mine, other = (r[cmd] for r in results)
    path, renders, volumes = exports_one[cmd]
    assert other["value"] is None and other["writes"] == []
    assert len(mine["writes"]) == 1
    assert mine["value"].read_bytes() == path.read_bytes()
    assert len(mine["renders"]) == len(other["renders"]) == len(renders)
    for (cam, a), (cam1, b) in zip(mine["renders"], renders):
        for k in cam:
            np.testing.assert_array_equal(cam[k], cam1[k])
        for k in RENDER_KEYS:
            np.testing.assert_array_equal(a[k], b[k])
    assert len(mine["volumes"]) == len(volumes) == (cmd == "marching-cubes")
    for a, b, c in zip(mine["volumes"], other["volumes"], volumes):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, c)
    if cmd == "pointcloud":
        assert len(renders) == 2 and path.stat().st_size > 200


# ---------------------------------------------------------------------------
# (d) the standalone viewer
# ---------------------------------------------------------------------------

def test_viewer_at_world_two_answers_with_both_ranks(pair, run, monkeypatch):
    results, _, _ = pair
    mine, other = (r["viewer"] for r in results)
    client = mine["value"]["client"]
    # two /render, two path frames, and the cancelled job's frames: every
    # rank took part in each
    done = client["cancelled"]["frame"]
    assert client["path"]["frame"] == 2 and client["path"]["path"]
    assert client["cancelled"].get("cancelled") is True
    assert done < ranks.PATH_CANCEL_FRAMES
    assert mine["value"]["renders"] == other["value"]["renders"] == 2 + 2 + done
    assert other["writes"] == []
    _, _, config = run
    with monkeypatch.context() as m:
        m.setattr(mesh, "local_world_size", lambda n, device_type: 1)
        alone = viewer.main(_viewer_argv(config), device="cpu",
                            on_serve=ranks.viewer_client)
    assert alone["renders"] == 0
    for a, b in zip(client["png"], alone["client"]["png"]):
        np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(a))),
                                      np.asarray(Image.open(io.BytesIO(b))))


def test_viewer_main_spawns_its_ranks_and_stops_them(run):
    """``snt-viewer`` on the run's two devices: a cancel, then the
    shutdown, and the command returns within JOIN_S of its last
    request."""
    _, _, config = run
    t0 = time.monotonic()
    served = viewer.main(_viewer_argv(config), device="cpu",
                         on_serve=ranks.viewer_client)
    end = time.monotonic()
    assert not mesh.current_world()
    assert served["client"]["cancelled"].get("cancelled") is True
    assert served["renders"] >= 4
    assert end - served["client"]["t_last"] < JOIN_S and end - t0 < 3 * JOIN_S


# ---------------------------------------------------------------------------
# (e) the live viewer over ranks
# ---------------------------------------------------------------------------

def test_live_viewer_renders_over_both_ranks_between_steps(pair):
    results, _, _ = pair
    (served0, plain0), (served1, plain1) = (r["live"] for r in results)
    assert served0["served"] and not served1["served"]
    assert served0["has_dispatcher"] and served1["has_dispatcher"]
    assert served0["reply"]["status"] == 200
    png = np.asarray(Image.open(io.BytesIO(served0["reply"]["body"])))
    assert png.shape == (12, 16, 3)
    # one render, split over both ranks; one broadcast a step
    steps = served0["steps"]
    assert served0["renders"] == served1["renders"] == 1
    assert served0["broadcasts"] == served1["broadcasts"] == steps
    # the run without the viewer broadcasts nothing, and ends in the
    # same state, bit for bit
    assert not plain0["has_dispatcher"] and plain0["broadcasts"] == 0
    assert plain1["broadcasts"] == 0 and plain0["steps"] == steps
    assert len(served0["state"]) == len(plain0["state"])
    for a, b in zip(served0["state"], plain0["state"]):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# (f) a failing rank
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("entry, failing_rank",
                         [("render", 1), ("viewer", 1), ("viewer", 0)])
def test_a_failing_render_fails_the_command_within_the_timeout(
        run, tmp_path, entry, failing_rank):
    _, _, config = run
    argv = (_render_argv(config, tmp_path) if entry == "render"
            else _viewer_argv(config))
    t0 = time.monotonic()
    with pytest.raises(Exception) as info:
        mesh.spawn(ranks.failing_entry_job, 2, (entry, argv, failing_rank),
                   devices=["cpu", "cpu"], timeout_s=FAIL_TIMEOUT_S)
    assert time.monotonic() - t0 < FAIL_TIMEOUT_S
    text = str(info.value) + "".join(getattr(info.value, "__notes__", []))
    assert f"rank {failing_rank} fails on purpose" in text
    assert not mesh.current_world()
    assert not list(tmp_path.rglob("*.png"))
