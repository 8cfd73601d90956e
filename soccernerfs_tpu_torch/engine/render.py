"""Whole-image rendering (counterpart of soccernerfs_tpu's
``Trainer.render_camera``): fixed-size chunks with a zero-padded tail; a
model that stages tables for rendering (K-Planes' bf16 plane tables) does
so once per parameter snapshot, and a model with non-trainable state (the
occupancy grid) renders with its ``eval_kwargs``, made once per image.
Every matmul of a render runs in full f32 (TF32 off), whatever the
caller's setting."""
from __future__ import annotations

from typing import Dict, Optional

import torch

from soccernerfs_tpu_torch.core.cameras import Cameras, generate_rays, get_image_coords
from soccernerfs_tpu_torch.models import get_model
from soccernerfs_tpu_torch.utils.device import full_f32, resolve_device
from soccernerfs_tpu_torch.utils.tree import tree_leaves

OUTPUT_KEYS = ("rgb", "depth", "accumulation")


def render_camera(
    cfg,
    params: dict,
    cameras: Cameras,
    camera_index: int,
    chunk: Optional[int] = None,
    device=None,
    *,
    aabb,
    model: str = "kplanes",
    aux: Optional[dict] = None,
) -> Dict[str, torch.Tensor]:
    """Render one camera's image.

    Args:
        cfg: the model config.
        params: the model's params (its ``init`` layout, e.g. from
            ``convert.params_from_jax``) on ``device``; a model with
            ``prepare_render_params`` stages them once here unless that
            already ran on them.  A "camera_opt" group is ignored: pose
            corrections belong to the training cameras.
        cameras: the cameras, moved to ``device``.
        camera_index: which camera.
        chunk: rays per forward (default ``cfg.eval_num_rays_per_chunk``).
        device: default CUDA; raises when CUDA is absent and the caller
            did not ask for another device.
        aabb: [2, 3] scene box.
        model: the model's registry name (models/__init__.py).
        aux: the model's non-trainable state on ``device`` (``TrainState.aux``,
            e.g. ``{"occs": ...}``); every chunk's forward takes the model's
            ``eval_kwargs`` of it.  None: the forward's defaults (an
            occupancy model then treats every cell as occupied).
    Returns:
        {"rgb": [H, W, 3], "depth": [H, W], "accumulation": [H, W]} on
        ``device``, and the model's further ``RENDER_OUTPUTS`` (NeRFPlayer's
        component probabilities "probs" [H, W, 3]).
    """
    dev = resolve_device(device)
    module = get_model(model)
    leaf = tree_leaves(params["fields"])[0]
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

    if hasattr(module, "prepare_render_params"):
        params = module.prepare_render_params(cfg, params)
    extra = {}
    if aux is not None:
        if not hasattr(module, "eval_kwargs"):
            raise ValueError(f"model {model!r} takes no state (aux)")
        extra = module.eval_kwargs(cfg, aux)
    keys = getattr(module, "RENDER_OUTPUTS", OUTPUT_KEYS)
    outs = {k: [] for k in keys}
    with torch.no_grad(), full_f32():
        for i in range(0, n_pad, chunk):
            rays = generate_rays(cameras, cam_idx[i:i + chunk],
                                 coords[i:i + chunk])
            o = module.get_outputs(cfg, params, aabb, rays, train=False, **extra)
            for k in keys:
                outs[k].append(o[k])
    return {
        k: torch.cat(v)[:n].reshape(h, w, *v[0].shape[1:])
        for k, v in outs.items()
    }
