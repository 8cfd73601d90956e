"""Camera paths for rendering (counterpart of
soccernerfs_tpu/core/camera_paths.py).

Spiral paths around a camera, pose-interpolated paths through cameras,
and the viewer's ``camera_path.json`` (written from keyframes, parsed
back).  The poses are made on the host in numpy, as in the JAX package;
the paths are ``Cameras`` on the input cameras' device (a parsed JSON
path: on ``device``).
"""
from __future__ import annotations

import numpy as np

from soccernerfs_tpu_torch.core.cameras import Cameras


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _slerp(q0, q1, t):
    d = np.clip(np.dot(q0, q1), -1.0, 1.0)
    if d < 0:
        q1, d = -q1, -d
    if d > 0.9995:
        out = q0 + t * (q1 - q0)
        return out / np.linalg.norm(out)
    theta0 = np.arccos(d)
    theta = theta0 * t
    s1 = np.sin(theta) / np.sin(theta0)
    s0 = np.cos(theta) - d * s1
    return s0 * q0 + s1 * q1


def _mat_to_quat(m):
    t = np.trace(m)
    if t > 0:
        s = 0.5 / np.sqrt(t + 1.0)
        return np.array(
            [0.25 / s, (m[2, 1] - m[1, 2]) * s, (m[0, 2] - m[2, 0]) * s, (m[1, 0] - m[0, 1]) * s]
        )
    i = int(np.argmax(np.diag(m)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = 2.0 * np.sqrt(max(1.0 + m[i, i] - m[j, j] - m[k, k], 1e-12))
    q = np.zeros(4)
    q[0] = (m[k, j] - m[j, k]) / s
    q[i + 1] = 0.25 * s
    q[j + 1] = (m[j, i] + m[i, j]) / s
    q[k + 1] = (m[k, i] + m[i, k]) / s
    return q


def _quat_to_mat(q):
    w, x, y, z = q / np.linalg.norm(q)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ]
    )


def get_interpolated_camera_path(cameras: Cameras, steps: int) -> Cameras:
    """Slerp rotations and lerp positions through ``cameras`` in order,
    ``steps // (n - 1)`` frames per segment (at least one), at the first
    camera's intrinsics, times spread over [0, 1]."""
    c2w = _host(cameras.camera_to_worlds)
    n = c2w.shape[0]
    out = []
    seg_steps = max(steps // max(n - 1, 1), 1)
    for i in range(n - 1):
        q0, q1 = _mat_to_quat(c2w[i, :, :3]), _mat_to_quat(c2w[i + 1, :, :3])
        for s in range(seg_steps):
            t = s / seg_steps
            R = _quat_to_mat(_slerp(q0, q1, t))
            p = c2w[i, :, 3] * (1 - t) + c2w[i + 1, :, 3] * t
            out.append(np.concatenate([R, p[:, None]], axis=-1))
    poses = np.stack(out).astype(np.float32)
    k = len(out)
    return Cameras.create(
        camera_to_worlds=poses,
        fx=np.full(k, float(cameras.fx[0])),
        fy=np.full(k, float(cameras.fy[0])),
        cx=np.full(k, float(cameras.cx[0])),
        cy=np.full(k, float(cameras.cy[0])),
        width=np.full(k, int(cameras.width[0]), np.int32),
        height=np.full(k, int(cameras.height[0]), np.int32),
        times=np.linspace(0, 1, k).astype(np.float32),
        device=cameras.camera_to_worlds.device,
    )


def get_spiral_path(
    cameras: Cameras,
    camera_index: int = 0,
    steps: int = 30,
    radius: float = 0.1,
    rots: int = 2,
    zrate: float = 0.5,
) -> Cameras:
    """``steps`` frames on a spiral of ``radius`` around camera
    ``camera_index``, ``rots`` turns, each looking at a point 0.5 in front
    of it, at its intrinsics, times spread over [0, 1]."""
    c2w = _host(cameras.camera_to_worlds)[camera_index]
    up = c2w[:3, 1]
    focus = 0.5
    target = c2w[:3, 3] - c2w[:3, 2] * focus

    poses = []
    for theta in np.linspace(0.0, 2.0 * np.pi * rots, steps + 1)[:-1]:
        offset = (
            c2w[:3, 0] * np.cos(theta) * radius
            + c2w[:3, 1] * np.sin(theta) * radius
            + c2w[:3, 2] * np.sin(theta * zrate) * radius * 0.5
        )
        position = c2w[:3, 3] + offset
        forward = target - position
        forward = forward / np.linalg.norm(forward)
        right = np.cross(forward, up)
        right = right / np.linalg.norm(right)
        true_up = np.cross(right, forward)
        pose = np.stack([right, true_up, -forward, position], axis=-1)
        poses.append(pose)
    poses = np.stack(poses).astype(np.float32)
    k = steps
    return Cameras.create(
        camera_to_worlds=poses,
        fx=np.full(k, float(cameras.fx[camera_index])),
        fy=np.full(k, float(cameras.fy[camera_index])),
        cx=np.full(k, float(cameras.cx[camera_index])),
        cy=np.full(k, float(cameras.cy[camera_index])),
        width=np.full(k, int(cameras.width[camera_index]), np.int32),
        height=np.full(k, int(cameras.height[camera_index]), np.int32),
        times=np.linspace(0, 1, k).astype(np.float32),
        device=cameras.camera_to_worlds.device,
    )


def keyframes_to_camera_path_json(
    keyframes,
    render_width: int,
    render_height: int,
    steps_per_transition: int = 24,
    fps: int = 24,
) -> dict:
    """Build a viewer-exported ``camera_path.json`` dict from keyframes.

    The inverse of :func:`get_path_from_json`: keyframe rotations are
    slerped, positions, fov and time interpolated linearly.

    Args:
        keyframes: list of dicts with ``c2w`` ([3][4] row lists), ``fov``
            (deg, vertical); optional ``time`` in [0, 1].
    Returns:
        a dict that ``snt-render --traj filename`` reads.
    """
    assert len(keyframes) >= 1
    frames = []

    def emit(c2w3x4, fov, t):
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3] = np.asarray(c2w3x4, np.float32)
        frame = {
            "camera_to_world": c2w.reshape(-1).tolist(),
            "fov": float(fov),
            "aspect": render_width / render_height,
        }
        if t is not None:
            frame["render_time"] = float(t)
        frames.append(frame)

    for a, b in zip(keyframes[:-1], keyframes[1:]):
        qa = _mat_to_quat(np.asarray(a["c2w"], np.float32)[:3, :3])
        qb = _mat_to_quat(np.asarray(b["c2w"], np.float32)[:3, :3])
        pa = np.asarray(a["c2w"], np.float32)[:3, 3]
        pb = np.asarray(b["c2w"], np.float32)[:3, 3]
        for s in range(steps_per_transition):
            t = s / steps_per_transition
            rot = _quat_to_mat(_slerp(qa, qb, t))
            pose = np.concatenate([rot, ((1 - t) * pa + t * pb)[:, None]], 1)
            fov = (1 - t) * a["fov"] + t * b["fov"]
            ta, tb = a.get("time"), b.get("time")
            tt = None if ta is None or tb is None else (1 - t) * ta + t * tb
            emit(pose, fov, tt)
    last = keyframes[-1]
    emit(np.asarray(last["c2w"], np.float32)[:3], last["fov"], last.get("time"))

    return {
        "render_height": int(render_height),
        "render_width": int(render_width),
        "fps": int(fps),
        "seconds": len(frames) / fps,
        "camera_path": frames,
        "keyframes": [
            {
                "camera_to_world": np.asarray(k["c2w"], np.float32).tolist(),
                "fov": float(k["fov"]),
                **({"render_time": float(k["time"])} if k.get("time") is not None else {}),
            }
            for k in keyframes
        ],
    }


def get_path_from_json(camera_path: dict, device=None) -> Cameras:
    """The cameras of a viewer-exported camera_path.json: per frame
    camera_to_world (16 floats, row-major), fov (degrees, vertical),
    aspect, an optional render_time; on ``device`` (default CUDA; raises
    when CUDA is absent and the caller did not ask for another device)."""
    h = int(camera_path["render_height"])
    w = int(camera_path["render_width"])
    c2ws, fxs, fys, times = [], [], [], []
    for frame in camera_path["camera_path"]:
        c2w = np.array(frame["camera_to_world"], dtype=np.float32).reshape(4, 4)[:3]
        c2ws.append(c2w)
        fov = float(frame["fov"])
        focal = h / 2.0 / np.tan(np.deg2rad(fov) / 2.0)
        fxs.append(focal)
        fys.append(focal)
        if "render_time" in frame:
            times.append(float(frame["render_time"]))
    k = len(c2ws)
    return Cameras.create(
        camera_to_worlds=np.stack(c2ws),
        fx=np.asarray(fxs, np.float32),
        fy=np.asarray(fys, np.float32),
        cx=np.full(k, w / 2.0, np.float32),
        cy=np.full(k, h / 2.0, np.float32),
        width=np.full(k, w, np.int32),
        height=np.full(k, h, np.int32),
        times=np.asarray(times, np.float32) if times else None,
        device=device,
    )
