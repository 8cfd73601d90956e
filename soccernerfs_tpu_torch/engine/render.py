"""Whole-image rendering (counterpart of soccernerfs_tpu's
``Trainer.render_camera``): fixed-size chunks with a zero-padded tail, the
plane tables staged once per parameter snapshot."""
from __future__ import annotations

from typing import Dict, Optional

import torch

from soccernerfs_tpu_torch.core.cameras import Cameras, generate_rays, get_image_coords
from soccernerfs_tpu_torch.models import kplanes
from soccernerfs_tpu_torch.utils.device import resolve_device

OUTPUT_KEYS = ("rgb", "depth", "accumulation")


def render_camera(
    cfg: kplanes.Config,
    params: dict,
    cameras: Cameras,
    camera_index: int,
    chunk: Optional[int] = None,
    device=None,
    *,
    aabb,
) -> Dict[str, torch.Tensor]:
    """Render one camera's image.

    Args:
        cfg: the model config.
        params: the model's params (``models/kplanes.init`` layout, e.g.
            from ``convert.params_from_jax``) on ``device``; staged once
            here unless ``prepare_render_params`` already ran on them.
        cameras: the cameras, moved to ``device``.
        camera_index: which camera.
        chunk: rays per forward (default ``cfg.eval_num_rays_per_chunk``).
        device: default CUDA; raises when CUDA is absent and the caller
            did not ask for another device.
        aabb: [2, 3] scene box.
    Returns:
        {"rgb": [H, W, 3], "depth": [H, W], "accumulation": [H, W]} on
        ``device``.
    """
    dev = resolve_device(device)
    if dev.type == "cuda":
        # the bf16 MLP policy multiplies in f32: TF32 would round further
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    leaf = params["fields"]["grids"][0][0]
    if leaf.device.type != dev.type:
        raise ValueError(f"params are on {leaf.device}, rendering on {dev}")
    chunk = chunk or cfg.eval_num_rays_per_chunk
    cameras = cameras.to(dev)
    aabb = torch.as_tensor(aabb, dtype=torch.float32, device=dev)
    h = int(cameras.height[camera_index])
    w = int(cameras.width[camera_index])
    coords = get_image_coords(h, w, device=dev).reshape(-1, 2)
    n = coords.shape[0]
    n_pad = (n + chunk - 1) // chunk * chunk
    coords = torch.cat([coords, torch.zeros((n_pad - n, 2), device=dev)])
    cam_idx = torch.full((n_pad,), camera_index, dtype=torch.int32, device=dev)

    if "grids_packed" not in params["fields"]:
        params = kplanes.prepare_render_params(cfg, params)
    outs = {k: [] for k in OUTPUT_KEYS}
    with torch.no_grad():
        for i in range(0, n_pad, chunk):
            rays = generate_rays(cameras, cam_idx[i:i + chunk],
                                 coords[i:i + chunk])
            o = kplanes.get_outputs(cfg, params, aabb, rays, train=False)
            for k in OUTPUT_KEYS:
                outs[k].append(o[k])
    return {
        k: torch.cat(v)[:n].reshape(h, w, *v[0].shape[1:])
        for k, v in outs.items()
    }
