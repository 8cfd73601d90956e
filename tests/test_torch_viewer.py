"""The port's viewer server (``viewer/server.py``): tests/
test_camera_path_authoring.py's ``ViewerState`` cases on the port, held
to the JAX package's ``ViewerState`` on the same keyframes and outputs,
then a real ``make_server`` on a free local port answering /scene,
/render (a PNG of the asked size, rendered from a small K-Planes
snapshot), /keyframe and /export_path.
"""
import base64
import dataclasses
import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from soccernerfs_tpu.viewer import server as jserver
from soccernerfs_tpu_torch.core.camera_paths import (
    get_path_from_json,
    keyframes_to_camera_path_json,
)
from soccernerfs_tpu_torch.core.cameras import Cameras
from soccernerfs_tpu_torch.viewer import server
from soccernerfs_tpu_torch.viewer.server import ViewerState, make_server


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch CPU thread while this file runs (the suite runs in
    parallel worker processes, whose default thread pools oversubscribe
    the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _kf(pos, fov, time=None):
    c2w = np.eye(4, dtype=np.float32)[:3]
    c2w[:, 3] = pos
    kf = {"c2w": c2w.tolist(), "fov": fov}
    if time is not None:
        kf["time"] = time
    return kf


def test_keyframes_interpolate_and_parse():
    kfs = [_kf([0, 0, 2], 50.0, 0.0), _kf([1, 0, 2], 70.0, 1.0)]
    payload = keyframes_to_camera_path_json(kfs, 64, 48, steps_per_transition=4)
    assert payload["render_width"] == 64 and payload["render_height"] == 48
    assert len(payload["camera_path"]) == 5  # 4 interpolated + final

    cams = get_path_from_json(payload, device="cpu")
    assert cams.num_cameras == 5
    c2w = cams.camera_to_worlds.numpy()
    np.testing.assert_allclose(c2w[0, :, 3], [0, 0, 2], atol=1e-6)
    np.testing.assert_allclose(c2w[-1, :, 3], [1, 0, 2], atol=1e-6)
    np.testing.assert_allclose(c2w[2, 0, 3], 0.5, atol=1e-6)
    assert float(cams.fx[0]) > float(cams.fx[-1])
    np.testing.assert_allclose(cams.times.numpy()[[0, -1]], [0.0, 1.0])


def _states(tmp_path, trainer=None, jax_trainer=None):
    return (ViewerState(trainer, output_dir=tmp_path / "port"),
            jserver.ViewerState(jax_trainer, output_dir=tmp_path / "jax"))


def test_viewer_state_export_writes_json(tmp_path):
    port, jax_state = _states(tmp_path)
    c2w = np.eye(4, dtype=np.float32)[:3].tolist()
    for state in (port, jax_state):
        assert state.add_keyframe(c2w, 60.0, 0.2) == 1
        assert state.add_keyframe(c2w, 60.0, 0.8) == 2
    payload = port.export_path(width=32, height=24, steps_per_transition=3)
    jax_payload = jax_state.export_path(width=32, height=24, steps_per_transition=3)
    saved = json.loads((tmp_path / "port" / "camera_path.json").read_text())
    assert saved == json.loads((tmp_path / "jax" / "camera_path.json").read_text())
    assert saved["render_width"] == 32 and len(saved["camera_path"]) == 4
    assert get_path_from_json(saved, device="cpu").num_cameras == 4
    assert payload["path"] == str(tmp_path / "port" / "camera_path.json")
    assert {k: v for k, v in payload.items() if k != "path"} == {
        k: v for k, v in jax_payload.items() if k != "path"}
    assert "error" in ViewerState(None, tmp_path).export_path()


def test_viewer_path_cameras_preview(tmp_path):
    port, jax_state = _states(tmp_path)
    for state in (port, jax_state):
        state.add_keyframe(_kf([0, 0, 2], 50.0)["c2w"], 50.0, 0.0)
        state.add_keyframe(_kf([1, 0, 2], 70.0)["c2w"], 70.0, 1.0)
    frames = port.path_cameras(steps_per_transition=4)
    jax_frames = jax_state.path_cameras(steps_per_transition=4)
    assert len(frames) == len(jax_frames) == 5
    for a, b in zip(frames, jax_frames):
        assert a.keys() == b.keys()
        np.testing.assert_allclose(a["c2w"], b["c2w"], rtol=0, atol=1e-6)
        assert a["fov"] == pytest.approx(b["fov"], rel=1e-6)
        assert a["time"] == b["time"]
    np.testing.assert_allclose(frames[0]["fov"], 50.0, atol=0.1)
    np.testing.assert_allclose(frames[-1]["fov"], 70.0, atol=0.1)
    np.testing.assert_allclose(np.asarray(frames[2]["c2w"])[0, 3], 0.5, atol=1e-5)
    assert frames[0]["time"] == 0.0 and frames[-1]["time"] == 1.0
    solo = ViewerState(trainer=None, output_dir=tmp_path)
    solo.add_keyframe(_kf([0, 0, 2], 60.0)["c2w"], 60.0)
    assert len(solo.path_cameras()) == 1


def test_viewer_remove_keyframe_and_output_modes(tmp_path):
    state = ViewerState(trainer=None, output_dir=tmp_path)
    c2w = np.eye(4, dtype=np.float32)[:3].tolist()
    state.add_keyframe(c2w, 60.0)
    state.add_keyframe(c2w, 80.0)
    state.keyframes.pop(0)
    assert len(state.keyframes) == 1 and state.keyframes[0]["fov"] == 80.0
    outputs = {
        "rgb": np.random.default_rng(0).uniform(0, 1, (4, 6, 3)),
        "depth": np.linspace(1, 3, 24).reshape(4, 6),
        "accumulation": np.random.default_rng(1).uniform(0, 1, (4, 6)),
    }
    for mode in ("rgb", "depth", "accumulation"):
        img = ViewerState._to_rgb8(outputs, mode)
        assert img.shape == (4, 6, 3) and img.dtype == np.uint8
        np.testing.assert_array_equal(img, jserver.ViewerState._to_rgb8(outputs, mode))


def test_viewer_update_keyframe_and_scene_tree(tmp_path):
    state = ViewerState(trainer=None, output_dir=tmp_path)
    c2w = np.eye(4, dtype=np.float32)[:3].tolist()
    state.add_keyframe(c2w, 60.0, time=0.2)
    moved = [row[:] for row in c2w]
    moved[0][3] = 1.5
    out = state.update_keyframe(0, c2w=moved, fov=75.0)
    assert out["keyframe"]["fov"] == 75.0
    assert state.keyframes[0]["c2w"][0][3] == 1.5
    assert state.keyframes[0]["time"] == 0.2
    assert "error" in state.update_keyframe(3)
    assert "error" in state.update_keyframe(0, c2w=[[1, 2]])
    assert state.set_scene_tree() == {
        "frustums": True, "thumbnails": True, "labels": True,
        "keyframes": True, "path": True,
    }
    tree = state.set_scene_tree({"thumbnails": False, "bogus": False})
    assert tree["thumbnails"] is False and "bogus" not in tree
    assert state.set_scene_tree()["thumbnails"] is False


def test_viewer_render_preview_and_cancel(tmp_path):
    state = ViewerState(trainer=None, output_dir=tmp_path)
    assert state.render_preview() is None
    assert "error" in state.cancel_render()
    state.render_job = {"running": True, "frame": 2, "total": 5,
                        "_preview": b"\xff\xd8jpegbytes"}
    status = state.render_status()
    assert status["frame"] == 2 and "_preview" not in status
    assert state.render_preview() == b"\xff\xd8jpegbytes"
    assert state.cancel_render() == {"cancelling": True}
    assert state.render_job["cancel"] is True


class _Dataset:
    def get_image(self, i):
        return np.full((8, 12, 3), 0.5, np.float32)


class _DM:
    train_dataset = _Dataset()


def _fake_trainers():
    arrays = dict(camera_to_worlds=np.tile(np.eye(4, dtype=np.float32)[:3][None],
                                           (3, 1, 1)),
                  fy=np.full((3,), 40.0, np.float32),
                  height=np.full((3,), 48, np.int32),
                  width=np.full((3,), 64, np.int32))
    aabb = [[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]]
    port = type("T", (), {
        "train_cameras": Cameras.create(fx=40.0, cx=32.0, cy=24.0,
                                        device="cpu", **arrays),
        "datamanager": _DM(), "aabb": torch.tensor(aabb)})()
    jax_cams = type("C", (), {"num_cameras": 3, "times": None, **arrays})()
    jax_trainer = type("T", (), {"train_cameras": jax_cams, "datamanager": _DM(),
                                 "aabb": np.asarray(aabb)})()
    return port, jax_trainer


def test_viewer_scene_cameras_and_meta_match_jax(tmp_path):
    port, jax_state = _states(tmp_path, *_fake_trainers())
    out = port.scene_cameras(thumb_px=8)
    assert out == jax_state.scene_cameras(thumb_px=8)
    assert len(out["cameras"]) == 3 and len(base64.b64decode(
        out["cameras"][0]["thumb"])) > 50
    assert port.scene_meta() == jax_state.scene_meta()


def test_viewer_export_commands_and_logs(tmp_path):
    state = ViewerState(trainer=None, output_dir=tmp_path)
    cmds = state.export_commands({"min": (-0.5, -0.5, 0.0), "max": (0.5, 0.5, 1.0)})
    assert set(cmds) == set(jserver.ViewerState(None, tmp_path).export_commands())
    assert "soccernerfs_tpu_torch.scripts.render" in cmds["render"]
    assert str(tmp_path / "config.yml") in cmds["render"]
    assert "--traj filename" in cmds["render"]
    assert "--bbox-min -0.5 -0.5 0.0" in cmds["export_pointcloud"]
    # the export panel names the port's exporter; its commands without a
    # crop parse with the exporter's own argparse (ROADMAP C.28 says why
    # the crop's are left out here)
    from soccernerfs_tpu_torch.scripts.exporter import build_parser

    plain = state.export_commands()
    prefix = "python -m soccernerfs_tpu_torch.scripts.exporter "
    for key, sub in (("export_pointcloud", "pointcloud"), ("export_mesh", "poisson")):
        assert cmds[key].startswith(prefix + sub) and plain[key].startswith(prefix + sub)
        args = build_parser().parse_args(plain[key][len(prefix):].split())
        assert args.cmd == sub and args.load_config == tmp_path / "config.yml"
    state.log("hello")
    from soccernerfs_tpu_torch.utils import writer

    writer.put_scalar("Train Loss", 0.25, 7)
    writer.write_out_storage()
    logs = state.recent_logs()
    assert any("hello" in ln for ln in logs)
    assert any("Train Loss" in ln and "0.25" in ln for ln in logs)


def test_viewer_page_is_the_jax_page():
    assert server._PAGE == jserver._PAGE.replace(
        "<title>soccernerfs_tpu viewer</title>",
        "<title>soccernerfs_tpu_torch viewer</title>")
    for needle in ("update_keyframe", "scene_tree", "render_preview",
                   "cancel_render", "rmodal", "kfedit", "treepanel",
                   "onpointerdown"):
        assert needle in server._PAGE, needle


class _Snapshot:
    """A small K-Planes snapshot (seeded planes, noisy time planes) with
    the trainer's render surface, on the CPU."""

    def __init__(self):
        from soccernerfs_tpu_torch.configs import method_configs as mc
        from soccernerfs_tpu_torch.convert import params_from_jax, seeded_params
        from soccernerfs_tpu_torch.data.fixtures import _look_at_pose

        self.cfg = dataclasses.replace(
            mc.model_configs["k-planes"], spacetime_resolution=(16, 16, 16, 4),
            multiscale_res=(1,), feature_dim=4,
            proposal_net_args_list=({"feature_dim": 4, "resolution": (8, 8, 8, 4)},
                                    {"feature_dim": 4, "resolution": (16, 16, 16, 4)}),
            num_proposal_samples_per_ray=(8, 6), num_nerf_samples_per_ray=4,
            sigma_net_hidden_dim=16, rgb_net_hidden_dim=16,
            eval_num_rays_per_chunk=512)
        self.device = torch.device("cpu")
        self.params = params_from_jax(seeded_params(self.cfg, 0, time_noise=0.05),
                                      device=self.device)
        self.aabb = torch.tensor([[-1.5] * 3, [1.5] * 3])
        poses = np.stack([_look_at_pose([2.5 * np.cos(a), 2.5 * np.sin(a), 1.0])[:3]
                          for a in (0.0, 2.0)]).astype(np.float32)
        self.train_cameras = Cameras.create(
            camera_to_worlds=poses, fx=30.0, fy=30.0, cx=16.0, cy=12.0, width=32,
            height=24, times=np.array([0.0, 1.0], np.float32), device="cpu")

    def render_camera(self, cameras, i):
        from soccernerfs_tpu_torch.engine.render import render_camera

        out = render_camera(self.cfg, self.params, cameras, i, device=self.device,
                            aabb=self.aabb, model="kplanes")
        return {k: v.numpy() for k, v in out.items()}


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=60) as reply:
        return reply.read(), reply.headers["Content-Type"]


def test_make_server_answers_render_requests(tmp_path):
    """The threaded server on a free port of 127.0.0.1: /scene, the page,
    rgb and depth /render as PNGs of the asked sizes, /keyframe and
    /export_path, and an error as a 500 with its message; then shut
    down."""
    snapshot = _Snapshot()
    srv = make_server(snapshot, "127.0.0.1", 0, output_dir=tmp_path)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        with urllib.request.urlopen(f"{url}/scene", timeout=60) as reply:
            scene = json.loads(reply.read())
        assert scene == {"num_cameras": 2, "has_time": True,
                         "aabb": [[-1.5] * 3, [1.5] * 3]}
        with urllib.request.urlopen(f"{url}/", timeout=60) as reply:
            assert b"soccernerfs_tpu_torch viewer" in reply.read()
        c2w = snapshot.train_cameras.camera_to_worlds[0].tolist()
        images = {}
        for (width, height), output in (((24, 16), "rgb"), ((40, 24), "depth")):
            png, ctype = _post(f"{url}/render", {"c2w": c2w, "fov": 50.0,
                                                  "width": width, "height": height,
                                                  "time": 0.5, "output": output})
            assert ctype == "image/png"
            images[output] = np.asarray(Image.open(io.BytesIO(png)))
            assert images[output].shape == (height, width, 3)
        assert images["rgb"].std() > 0
        for i, t in enumerate((0.0, 1.0)):
            reply, _ = _post(f"{url}/keyframe", {"c2w": c2w, "fov": 50.0 + 10 * i,
                                                  "time": t})
            assert json.loads(reply) == {"count": i + 1}
        exported = json.loads(_post(f"{url}/export_path", {
            "width": 32, "height": 24, "steps_per_transition": 2})[0])
        assert len(exported["camera_path"]) == 3
        assert (tmp_path / "camera_path.json").is_file()
        with pytest.raises(urllib.error.HTTPError) as error:
            _post(f"{url}/render", {"fov": 50.0})
        assert error.value.code == 500
        assert "c2w" in json.loads(error.value.read())["error"]
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=60)
    assert not thread.is_alive()


def _live_trainer(tmp_path, vis):
    """A narrow depth-nerfacto Trainer on a nerfstudio scene, set up for
    training with ``vis``, its viewer (if any) on a free port."""
    import copy

    from soccernerfs_tpu_torch.configs.method_configs import trainer_configs
    from soccernerfs_tpu_torch.data.dataparsers import DATAPARSERS
    from soccernerfs_tpu_torch.data.fixtures import make_nerfstudio_fixture
    from soccernerfs_tpu_torch.engine.trainer import Trainer

    data = make_nerfstudio_fixture(tmp_path / "ns", num_frames=10, h=12, w=16)
    cfg = copy.deepcopy(trainer_configs["depth-nerfacto"])
    cfg.pipeline.model = dataclasses.replace(
        cfg.pipeline.model, num_levels=3, max_res=32, log2_hashmap_size=11,
        hidden_dim=8, hidden_dim_color=8, num_proposal_samples_per_ray=(8, 6),
        num_nerf_samples_per_ray=4, eval_num_rays_per_chunk=128,
        proposal_net_args_list=(
            {"hidden_dim": 8, "log2_hashmap_size": 10, "num_levels": 2, "max_res": 16},
            {"hidden_dim": 8, "log2_hashmap_size": 10, "num_levels": 2, "max_res": 32},
        ))
    dm = cfg.pipeline.datamanager
    dm.dataparser = DATAPARSERS["nerfstudio-data"](data=data)
    dm.train_num_rays_per_batch = dm.eval_num_rays_per_batch = 64
    cfg.vis, cfg.viewer.websocket_port = vis, 0
    cfg.output_dir, cfg.timestamp = tmp_path / "out", "t"
    return Trainer(cfg, device="cpu").setup()


def test_live_viewer_renders_between_training_steps(tmp_path, monkeypatch):
    """A Trainer whose vis names the viewer serves it from ``setup`` on:
    while another thread runs 12 ``train_iteration`` steps, four client
    threads each get three /render PNGs.  No render overlaps a step (the
    step holds the viewer's render lock around its in-place update), the
    renders leave the step count alone, and ``shutdown`` stops the server.
    Without "viewer" in vis, no server starts."""
    import sys
    import time

    assert _live_trainer(tmp_path / "plain", "none").viewer_server is None
    trainer = _live_trainer(tmp_path / "live", "viewer")
    srv = trainer.viewer_server
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    spans = {"step": [], "render": []}
    step_fn, render_fn = trainer.train_step.train_iteration, trainer.render_camera

    def timed(kind, fn):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                spans[kind].append((t0, time.perf_counter()))
        return wrapper

    monkeypatch.setattr(trainer.train_step, "train_iteration",
                        timed("step", step_fn))
    monkeypatch.setattr(trainer, "render_camera", timed("render", render_fn))
    c2w = trainer.train_cameras.camera_to_worlds[0].tolist()
    pngs, errors = [], []

    def client():
        try:
            for _ in range(3):
                png, _ = _post(f"{url}/render", {"c2w": c2w, "fov": 50.0,
                                                 "width": 16, "height": 12})
                pngs.append(np.asarray(Image.open(io.BytesIO(png))))
        except Exception as e:  # reported below
            errors.append(e)

    def train():
        for step in range(12):
            trainer.train_iteration(step)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=train)] + [
            threading.Thread(target=client) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
        srv.shutdown()
        srv.server_close()
    assert not errors, errors
    assert len(pngs) == 12 and all(p.shape == (12, 16, 3) for p in pngs)
    assert trainer.state.step == 12 and len(spans["step"]) == 12
    assert len(spans["render"]) == 12
    for a0, a1 in spans["render"]:
        assert all(a1 <= b0 or b1 <= a0 for b0, b1 in spans["step"])
