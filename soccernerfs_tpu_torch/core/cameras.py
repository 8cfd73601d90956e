"""Cameras and ray generation (counterpart of soccernerfs_tpu/core/cameras.py).

Cameras is a flat dataclass of per-camera tensors (``times``/``ids`` are the
dynamic-scene additions); ``generate_rays`` evaluates all three camera
models branchlessly and selects per ray, as the JAX version does.
"""
from __future__ import annotations

import dataclasses
import enum
import math
from dataclasses import dataclass
from typing import Optional

import torch

from soccernerfs_tpu_torch.core.rays import RayBundle
from soccernerfs_tpu_torch.utils.device import resolve_device


class CameraType(enum.IntEnum):
    PERSPECTIVE = 1
    FISHEYE = 2
    EQUIRECTANGULAR = 3


# a transforms.json "camera_model" -> CameraType
CAMERA_MODEL_TO_TYPE = {
    "SIMPLE_PINHOLE": CameraType.PERSPECTIVE,
    "PINHOLE": CameraType.PERSPECTIVE,
    "SIMPLE_RADIAL": CameraType.PERSPECTIVE,
    "RADIAL": CameraType.PERSPECTIVE,
    "OPENCV": CameraType.PERSPECTIVE,
    "OPENCV_FISHEYE": CameraType.FISHEYE,
    "EQUIRECTANGULAR": CameraType.EQUIRECTANGULAR,
}


@dataclass
class Cameras:
    """Batched cameras: per-camera scalars are [N], ``camera_to_worlds``
    is [N, 3, 4] in [R|t] form."""

    camera_to_worlds: torch.Tensor  # [N, 3, 4]
    fx: torch.Tensor  # [N]
    fy: torch.Tensor  # [N]
    cx: torch.Tensor  # [N]
    cy: torch.Tensor  # [N]
    width: torch.Tensor  # [N] int32
    height: torch.Tensor  # [N] int32
    distortion_params: Optional[torch.Tensor] = None  # [N, 6] k1 k2 k3 k4 p1 p2
    camera_type: Optional[torch.Tensor] = None  # [N] int32 CameraType values
    times: Optional[torch.Tensor] = None  # [N] in [0, 1]
    ids: Optional[torch.Tensor] = None  # [N] int32 physical-camera ids

    @property
    def num_cameras(self) -> int:
        return self.camera_to_worlds.shape[0]

    def to(self, device) -> "Cameras":
        return dataclasses.replace(
            self,
            **{
                f.name: getattr(self, f.name).to(device)
                for f in dataclasses.fields(self)
                if getattr(self, f.name) is not None
            },
        )

    @classmethod
    def create(
        cls,
        camera_to_worlds,
        fx,
        fy,
        cx,
        cy,
        width,
        height,
        distortion_params=None,
        camera_type=CameraType.PERSPECTIVE,
        times=None,
        ids=None,
        device=None,
    ) -> "Cameras":
        """Build Cameras with scalar broadcasting, on ``device``
        (default CUDA)."""
        dev = resolve_device(device)
        c2w = torch.as_tensor(camera_to_worlds, dtype=torch.float32, device=dev)
        n = c2w.shape[0]

        def bc(v, dtype=torch.float32):
            arr = torch.as_tensor(v, dtype=dtype, device=dev)
            return arr.expand(n).clone() if arr.ndim == 0 else arr

        def opt(v, dtype):
            return None if v is None else torch.as_tensor(v, dtype=dtype, device=dev)

        return cls(
            camera_to_worlds=c2w,
            fx=bc(fx),
            fy=bc(fy),
            cx=bc(cx),
            cy=bc(cy),
            width=bc(width, torch.int32),
            height=bc(height, torch.int32),
            distortion_params=opt(distortion_params, torch.float32),
            camera_type=bc(int(camera_type), torch.int32),
            times=opt(times, torch.float32),
            ids=opt(ids, torch.int32),
        )


def get_image_coords(
    height: int, width: int, pixel_offset: float = 0.5, device=None
) -> torch.Tensor:
    """[H, W, 2] (row, col) pixel-center coordinates."""
    y = torch.arange(height, dtype=torch.float32, device=device) + pixel_offset
    x = torch.arange(width, dtype=torch.float32, device=device) + pixel_offset
    yy, xx = torch.meshgrid(y, x, indexing="ij")
    return torch.stack([yy, xx], dim=-1)


def radial_and_tangential_undistort(
    coords: torch.Tensor,
    distortion_params: torch.Tensor,
    max_iterations: int = 10,
) -> torch.Tensor:
    """Invert the OpenCV radial+tangential distortion model with a fixed
    number of Newton iterations.

    Args:
        coords: [..., 2] distorted normalized image coords.
        distortion_params: [..., 6] (k1, k2, k3, k4, p1, p2).
    """
    k1, k2, k3, k4, p1, p2 = (distortion_params[..., i] for i in range(6))
    xd, yd = coords[..., 0], coords[..., 1]
    x, y = xd, yd
    for _ in range(max_iterations):
        r = x * x + y * y
        d = 1.0 + r * (k1 + r * (k2 + r * (k3 + r * k4)))
        fx = d * x + 2 * p1 * x * y + p2 * (r + 2 * x * x) - xd
        fy = d * y + 2 * p2 * x * y + p1 * (r + 2 * y * y) - yd
        d_r = k1 + r * (2.0 * k2 + r * (3.0 * k3 + r * 4.0 * k4))
        d_x = 2.0 * x * d_r
        d_y = 2.0 * y * d_r
        fx_x = d + d_x * x + 2.0 * p1 * y + 6.0 * p2 * x
        fx_y = d_y * x + 2.0 * p1 * x + 2.0 * p2 * y
        fy_x = d_x * y + 2.0 * p2 * y + 2.0 * p1 * x
        fy_y = d + d_y * y + 2.0 * p2 * x + 6.0 * p1 * y
        denom = fy_x * fx_y - fx_x * fy_y
        x_num = fx * fy_y - fy * fx_y
        y_num = fy * fx_x - fx * fy_x
        ok = torch.abs(denom) > 1e-3
        step_x = torch.where(ok, x_num / denom, torch.zeros_like(denom))
        step_y = torch.where(ok, y_num / denom, torch.zeros_like(denom))
        x, y = x + step_x, y + step_y
    return torch.stack([x, y], dim=-1)


def generate_rays(
    cameras: Cameras,
    camera_indices: torch.Tensor,
    coords: torch.Tensor,
    camera_opt_to_camera: Optional[torch.Tensor] = None,
    disable_distortion: bool = False,
) -> RayBundle:
    """World-space rays for (camera, pixel) pairs.

    +1 px offsets in x and y give the pixel-footprint estimate; directions
    are normalised after rotation to world space, and per-ray ``times``
    come from the camera.

    Args:
        camera_indices: [R] int indices into ``cameras``.
        coords: [R, 2] (row, col) pixel coordinates (typically +0.5).
        camera_opt_to_camera: [R, 3, 4] optional pose-optimizer correction,
            applied in the camera's frame.
    Returns:
        RayBundle with R rays.
    """
    idx = camera_indices.long()
    y = coords[..., 0]
    x = coords[..., 1]
    fx = cameras.fx[idx]
    fy = cameras.fy[idx]
    cx = cameras.cx[idx]
    cy = cameras.cy[idx]

    coord = torch.stack([(x - cx) / fx, -(y - cy) / fy], dim=-1)
    coord_x = torch.stack([(x - cx + 1) / fx, -(y - cy) / fy], dim=-1)
    coord_y = torch.stack([(x - cx) / fx, -(y - cy + 1) / fy], dim=-1)
    coord_stack = torch.stack([coord, coord_x, coord_y], dim=0)  # [3, R, 2]

    cam_type = (
        cameras.camera_type[idx]
        if cameras.camera_type is not None
        else torch.full(idx.shape, int(CameraType.PERSPECTIVE), dtype=torch.int32,
                        device=idx.device)
    )

    if not disable_distortion and cameras.distortion_params is not None:
        dist = cameras.distortion_params[idx]
        undistorted = radial_and_tangential_undistort(
            coord_stack, dist.expand((3,) + dist.shape)
        )
        # equirectangular cameras skip undistortion
        skip = (cam_type == int(CameraType.EQUIRECTANGULAR))[None, :, None]
        coord_stack = torch.where(skip, coord_stack, undistorted)

    cs0, cs1 = coord_stack[..., 0], coord_stack[..., 1]

    persp = torch.stack([cs0, cs1, -torch.ones_like(cs0)], dim=-1)

    theta = torch.sqrt(cs0**2 + cs1**2)
    theta = torch.clamp(theta, 0.0, math.pi)
    sin_over_theta = torch.sin(theta) / torch.clamp(theta, min=1e-9)
    fisheye = torch.stack(
        [cs0 * sin_over_theta, cs1 * sin_over_theta, -torch.cos(theta)], dim=-1
    )

    eq_theta = -math.pi * cs0
    eq_phi = math.pi * (0.5 - cs1)
    equirect = torch.stack(
        [
            -torch.sin(eq_theta) * torch.sin(eq_phi),
            torch.cos(eq_phi),
            -torch.cos(eq_theta) * torch.sin(eq_phi),
        ],
        dim=-1,
    )

    ct = cam_type[None, :, None]
    directions_stack = torch.where(
        ct == int(CameraType.FISHEYE),
        fisheye,
        torch.where(ct == int(CameraType.EQUIRECTANGULAR), equirect, persp),
    )  # [3, R, 3] camera-frame directions

    c2w = cameras.camera_to_worlds[idx]  # [R, 3, 4]
    if camera_opt_to_camera is not None:
        R1, t1 = c2w[..., :3], c2w[..., 3:]
        R2, t2 = camera_opt_to_camera[..., :3], camera_opt_to_camera[..., 3:]
        c2w = torch.cat([R1 @ R2, R1 @ t2 + t1], dim=-1)
    rotation = c2w[..., :3, :3]
    directions_stack = torch.einsum("srj,rij->sri", directions_stack, rotation)
    norms = torch.clamp(
        torch.linalg.vector_norm(directions_stack, dim=-1, keepdim=True), min=1e-10
    )
    directions_stack = directions_stack / norms

    origins = c2w[..., :3, 3]
    directions = directions_stack[0]
    dx = torch.sqrt(torch.sum((directions - directions_stack[1]) ** 2, dim=-1))
    dy = torch.sqrt(torch.sum((directions - directions_stack[2]) ** 2, dim=-1))
    pixel_area = dx * dy

    times = cameras.times[idx] if cameras.times is not None else None

    return RayBundle(
        origins=origins,
        directions=directions,
        pixel_area=pixel_area,
        camera_indices=camera_indices.to(torch.int32),
        times=times,
        directions_norm=norms[0, :, 0].detach(),
    )


def generate_image_rays(cameras: Cameras, camera_index: int,
                        camera_opt_to_camera=None) -> RayBundle:
    """All rays of one camera's image, flattened row-major, on the cameras'
    device."""
    dev = cameras.camera_to_worlds.device
    h = int(cameras.height[camera_index])
    w = int(cameras.width[camera_index])
    coords = get_image_coords(h, w, device=dev).reshape(-1, 2)
    idx = torch.full((coords.shape[0],), camera_index, dtype=torch.int32,
                     device=dev)
    return generate_rays(cameras, idx, coords, camera_opt_to_camera)
