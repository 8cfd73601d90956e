"""The port's camera paths (``core/camera_paths.py``), colour maps
(``utils/colormaps.py``) and ``scripts/render.render_trajectory``'s frames
against the JAX package's, on the same cameras and output arrays (numpy
seed 0): poses and intrinsics within 1e-6, times exact, colours and
uint8 frames equal.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from soccernerfs_tpu.core import camera_paths as jpaths
from soccernerfs_tpu.core.cameras import Cameras as JCameras
from soccernerfs_tpu.scripts.render import render_trajectory as jax_render_trajectory
from soccernerfs_tpu.utils import colormaps as jcolormaps
from soccernerfs_tpu_torch.core import camera_paths as paths
from soccernerfs_tpu_torch.core.cameras import Cameras
from soccernerfs_tpu_torch.scripts.render import render_trajectory
from soccernerfs_tpu_torch.utils import colormaps


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch CPU thread while this file runs (the suite runs in
    parallel worker processes, whose default thread pools oversubscribe
    the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _camera_arrays(n=5, seed=0):
    """Random rotations (QR of normals, det +1), positions, intrinsics and
    times."""
    rng = np.random.default_rng(seed)
    c2w = np.zeros((n, 3, 4), np.float32)
    for i in range(n):
        q, r = np.linalg.qr(rng.standard_normal((3, 3)))
        q = q * np.sign(np.diag(r))
        if np.linalg.det(q) < 0:
            q[:, 0] = -q[:, 0]
        c2w[i, :, :3] = q
        c2w[i, :, 3] = rng.uniform(-2, 2, 3)
    return dict(
        camera_to_worlds=c2w,
        fx=rng.uniform(300, 500, n).astype(np.float32),
        fy=rng.uniform(300, 500, n).astype(np.float32),
        cx=np.full(n, 48.0, np.float32), cy=np.full(n, 32.0, np.float32),
        width=np.full(n, 96, np.int32), height=np.full(n, 64, np.int32),
        times=np.sort(rng.uniform(0, 1, n)).astype(np.float32),
    )


def _both(n=5, seed=0):
    arrays = _camera_arrays(n, seed)
    return (Cameras.create(**arrays, device="cpu"),
            JCameras.create(**{k: jnp.asarray(v) for k, v in arrays.items()}))


def _assert_same_cameras(port, jax_cams):
    assert port.num_cameras == jax_cams.num_cameras
    np.testing.assert_allclose(port.camera_to_worlds.numpy(),
                               np.asarray(jax_cams.camera_to_worlds), rtol=0, atol=1e-6)
    for name in ("fx", "fy", "cx", "cy"):
        np.testing.assert_allclose(getattr(port, name).numpy(),
                                   np.asarray(getattr(jax_cams, name)),
                                   rtol=1e-6, atol=0)
    for name in ("width", "height"):
        np.testing.assert_array_equal(getattr(port, name).numpy(),
                                      np.asarray(getattr(jax_cams, name)))
    if jax_cams.times is None:
        assert port.times is None
    else:
        np.testing.assert_array_equal(port.times.numpy(), np.asarray(jax_cams.times))


@pytest.mark.parametrize("index, steps", [(0, 30), (3, 7)])
def test_spiral_path_matches_jax(index, steps):
    port, jax_cams = _both()
    _assert_same_cameras(paths.get_spiral_path(port, index, steps=steps),
                         jpaths.get_spiral_path(jax_cams, index, steps=steps))


@pytest.mark.parametrize("n, steps", [(5, 12), (2, 5), (4, 2)])
def test_interpolated_path_matches_jax(n, steps):
    port, jax_cams = _both(n)
    out = paths.get_interpolated_camera_path(port, steps)
    _assert_same_cameras(out, jpaths.get_interpolated_camera_path(jax_cams, steps))
    assert out.camera_to_worlds.device == port.camera_to_worlds.device


def _keyframes(seed=0, timed=True):
    arrays = _camera_arrays(3, seed)
    fovs = np.random.default_rng(seed + 1).uniform(30, 80, 3)
    return [{"c2w": c2w.tolist(), "fov": float(fov),
             **({"time": float(t)} if timed else {})}
            for c2w, fov, t in zip(arrays["camera_to_worlds"], fovs,
                                   arrays["times"])]


@pytest.mark.parametrize("timed", [True, False])
def test_camera_path_json_matches_jax(timed):
    """keyframes_to_camera_path_json's dict, then get_path_from_json's
    cameras, from the same keyframes."""
    kfs = _keyframes(timed=timed)
    port = paths.keyframes_to_camera_path_json(kfs, 64, 48, 5, fps=12)
    jax_json = jpaths.keyframes_to_camera_path_json(kfs, 64, 48, 5, fps=12)
    assert port.keys() == jax_json.keys()
    assert len(port["camera_path"]) == 2 * 5 + 1
    for key in ("render_height", "render_width", "fps", "seconds", "keyframes"):
        assert port[key] == jax_json[key], key
    for a, b in zip(port["camera_path"], jax_json["camera_path"]):
        assert a.keys() == b.keys()
        np.testing.assert_allclose(a["camera_to_world"], b["camera_to_world"],
                                   rtol=0, atol=1e-6)
        assert a["fov"] == pytest.approx(b["fov"], rel=1e-6)
        assert a.get("render_time") == b.get("render_time")
    # through JSON, as a file would carry it
    payload = json.loads(json.dumps(jax_json))
    _assert_same_cameras(paths.get_path_from_json(payload, device="cpu"),
                         jpaths.get_path_from_json(payload))


def _outputs(seed, h=12, w=20):
    rng = np.random.default_rng(seed)
    return {"rgb": rng.uniform(0, 1, (h, w, 3)).astype(np.float32),
            "depth": rng.uniform(0.5, 4, (h, w)).astype(np.float32),
            "accumulation": rng.uniform(0, 1, (h, w)).astype(np.float32)}


def test_colormaps_match_jax():
    out = _outputs(0)
    for values in (out["accumulation"], out["accumulation"][..., None],
                   np.linspace(-0.5, 1.5, 40).reshape(4, 10)):
        np.testing.assert_array_equal(colormaps.apply_colormap(values),
                                      jcolormaps.apply_colormap(values))
    for kwargs in ({}, {"accumulation": out["accumulation"]},
                   {"near_plane": 1.0, "far_plane": 2.0}):
        np.testing.assert_array_equal(
            colormaps.apply_depth_colormap(out["depth"], **kwargs),
            jcolormaps.apply_depth_colormap(out["depth"], **kwargs))


class _Frames:
    """A trainer stand-in whose renders are fixed output arrays."""

    def __init__(self, n):
        self.outputs = [_outputs(i) for i in range(n)]

    def render_camera(self, cameras, i):
        return self.outputs[i]


class _Path:
    num_cameras = 3


@pytest.mark.parametrize("names", [["rgb"], ["rgb", "depth", "accumulation"]])
def test_render_trajectory_frames_match_jax(tmp_path, names):
    """The same output arrays give the same composed uint8 frames (the PNG
    files of ``--output-format images``)."""
    trainer = _Frames(3)
    port_dir = render_trajectory(trainer, _Path(), names, tmp_path / "port.mp4",
                                 "images")
    jax_render_trajectory(trainer, _Path(), names, tmp_path / "jax.mp4", "images")
    port_pngs = sorted(port_dir.glob("*.png"))
    jax_pngs = sorted((tmp_path / "jax").glob("*.png"))
    assert port_dir == tmp_path / "port" and len(port_pngs) == len(jax_pngs) == 3
    for a, b in zip(port_pngs, jax_pngs):
        frame = np.asarray(Image.open(a))
        assert frame.shape == (12, 20 * len(names), 3) and frame.dtype == np.uint8
        np.testing.assert_array_equal(frame, np.asarray(Image.open(b)))
