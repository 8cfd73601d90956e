"""The scene every cell looks at: a ring of 20 cameras 2.5 from the origin,
960x540 at f = 800, looking at the scene box's centre, over the 100 frames
of the time axis; the viewer's orbit of moving 240x135 cameras; the pool of
seeded training batches.  Made here in numpy and torch, from the seed, and
handed alike to the program and to the reference."""
from __future__ import annotations

import numpy as np
import torch

RING = 20
FRAMES = 100
H, W, FOCAL = 540, 960, 800.0


def look_at(theta: float) -> np.ndarray:
    """[3, 4] camera-to-world of a camera at angle ``theta`` on the ring
    (elevation atan(0.5)), 2.5 from the origin, looking at it (-z)."""
    z = np.array([np.cos(theta), np.sin(theta), 0.5])
    z /= np.linalg.norm(z)
    x = np.cross(np.array([0.0, 0.0, 1.0]), z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    c2w = np.zeros((3, 4), np.float32)
    c2w[:, 0], c2w[:, 1], c2w[:, 2], c2w[:, 3] = x, y, z, z * 2.5
    return c2w


def frame_times() -> np.ndarray:
    return np.linspace(0.0, 1.0, FRAMES).astype(np.float32)


class CameraTable:
    """Cameras as the reference reads them: per-camera [N, 3, 4] poses,
    intrinsics and times, on ``device``; ``per_ray`` gathers them."""

    def __init__(self, c2w, fx, fy, cx, cy, width, height, times, device):
        n = len(c2w)
        t = lambda v: torch.as_tensor(np.broadcast_to(np.asarray(v, np.float32), (n,)).copy(),
                                      device=device)
        self.c2w = torch.as_tensor(np.asarray(c2w, np.float32), device=device)
        self.fx, self.fy, self.cx, self.cy = t(fx), t(fy), t(cx), t(cy)
        self.width, self.height = int(width), int(height)
        self.times = t(times)

    def per_ray(self, cam_idx):
        i = cam_idx.long()
        return (self.c2w[i], self.fx[i], self.fy[i], self.cx[i], self.cy[i],
                self.times[i])

    def port_cameras(self, device):
        """The same cameras as the program's ``Cameras``."""
        from soccernerfs_tpu_torch.core.cameras import Cameras

        return Cameras.create(
            camera_to_worlds=self.c2w.cpu().numpy(), fx=self.fx.cpu().numpy(),
            fy=self.fy.cpu().numpy(), cx=self.cx.cpu().numpy(),
            cy=self.cy.cpu().numpy(), width=self.width, height=self.height,
            times=self.times.cpu().numpy(), device=device)


def train_table(device, h=H, w=W, focal=FOCAL) -> CameraTable:
    """Every (ring camera, frame) pair as a camera: index = pose * 100 +
    frame."""
    poses = [look_at(2 * np.pi * i / RING) for i in range(RING)]
    c2w = np.stack([p for p in poses for _ in range(FRAMES)])
    times = np.tile(frame_times(), RING)
    return CameraTable(c2w, focal, focal, w / 2, h / 2, w, h, times, device)


def render_table(device, h=H, w=W, focal=FOCAL) -> CameraTable:
    """100 cameras: camera k is ring pose k % 20 at frame k."""
    c2w = np.stack([look_at(2 * np.pi * (k % RING) / RING) for k in range(FRAMES)])
    return CameraTable(c2w, focal, focal, w / 2, h / 2, w, h, frame_times(), device)


def orbit_pose(k: int) -> tuple:
    """The viewer's k-th request: (pose [3, 4], time), the camera 1 degree
    further round the ring and one frame on."""
    return look_at(np.deg2rad(k)), float(frame_times()[k % FRAMES])


def seeded(seed: int, *stream: int) -> int:
    """A generator seed for ``stream`` of a run's ``seed``."""
    state = np.random.SeedSequence([int(seed) % 2**64, *stream]).generate_state(1, np.uint64)
    return int(state[0] >> np.uint64(1))


def batch_pool(seed: int, batches: int, rays: int, table: CameraTable, device) -> list:
    """``batches`` training batches of ``rays`` random (camera, pixel,
    frame) with random target colours, drawn on the device in the
    program's batch layout (cam_idx int32, coords (row, col) + 0.5,
    image)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seeded(seed, 1))
    n = batches * rays
    cams = torch.randint(0, len(table.times), (n,), generator=gen, device=device,
                         dtype=torch.int64).to(torch.int32)
    rows = torch.randint(0, table.height, (n,), generator=gen, device=device)
    cols = torch.randint(0, table.width, (n,), generator=gen, device=device)
    coords = torch.stack([rows, cols], -1).to(torch.float32) + 0.5
    image = torch.rand((n, 3), generator=gen, device=device)
    return [{"cam_idx": cams[i * rays:(i + 1) * rays],
             "coords": coords[i * rays:(i + 1) * rays],
             "image": image[i * rays:(i + 1) * rays]} for i in range(batches)]
