"""Importance-sampling weights: IST, ISG and static ISS (counterpart of
soccernerfs_tpu/data/importance.py).

The image stack is processed per physical camera as one max-|diff| (IST)
or ψ-diff (ISG) pass in torch on the caller's device, with the JAX
package's thresholds, fallbacks, cache file names, ``offline`` semantics
and float16 output.  Caches are .npy files beside the images.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from soccernerfs_tpu_torch.utils.device import resolve_device

IST_ALPHA = 0.15  # parasite-motion threshold


def _cache_path(dataset, file_name: str) -> Path:
    return dataset.image_filenames[0].absolute().parent / file_name


def _try_load_cache(path: Path, expected_batch: int) -> Optional[np.ndarray]:
    if path.exists():
        weights = np.load(path)
        if weights.shape[0] == expected_batch:
            return weights
    return None


def ist_weights(images: torch.Tensor, close_mask: torch.Tensor) -> torch.Tensor:
    """Per-camera IST: for each frame, the max |diff| against its close
    frames.

    Args:
        images: [T, H, W, 3] one camera's frames.
        close_mask: [T, T] bool; close_mask[i, j] iff frame j is within
            (0.01, ist_range] of frame i in normalized time.
    Returns:
        [T, H, W] f32: the channel mean of the max diff, zeroed at or below
        IST_ALPHA; uniform 1s for a frame with no close frames.
    """
    out = []
    for i in range(images.shape[0]):
        diffs = torch.abs(images - images[i][None])
        masked = torch.where(close_mask[i][:, None, None, None], diffs, 0.0)
        max_diff = torch.amax(masked, dim=0).mean(dim=-1)
        max_diff = torch.where(max_diff > IST_ALPHA, max_diff, 0.0)
        out.append(torch.where(close_mask[i].any(), max_diff,
                               torch.ones_like(max_diff)))
    return torch.stack(out)


def isg_weights(images: torch.Tensor, gamma: float) -> torch.Tensor:
    """Per-camera ISG: ψ of the squared diff against the per-pixel temporal
    median, [T, H, W] f32.  For an even frame count the median is the mean
    of the two middle values, as ``jnp.median``'s."""
    t = images.shape[0]
    ordered = torch.sort(images, dim=0).values
    median = (ordered[(t - 1) // 2] + ordered[t // 2]) * 0.5
    sq = torch.square(images - median[None])
    psi = sq / (sq + gamma**2)
    return torch.sum(psi, dim=-1) / 3.0


def _cam_ids(cameras, img_idx: np.ndarray) -> np.ndarray:
    """Per-frame physical-camera ids for the grouping; a dataset without
    them is one camera."""
    if cameras.ids is None:
        return np.zeros(img_idx.shape, dtype=np.int32)
    return cameras.ids.cpu().numpy()[img_idx]


def _per_camera(images: np.ndarray, cam_ids: np.ndarray, device, weights_fn
                ) -> np.ndarray:
    """``weights_fn(frames of one camera, their positions)`` for each
    camera, gathered into [B, H, W] float16 on the host."""
    dev = resolve_device(device)
    B, H, W = images.shape[:3]
    out = torch.empty((B, H, W), dtype=torch.float16, device=dev)
    for cam in np.unique(cam_ids):
        sel = np.nonzero(cam_ids == cam)[0]
        frames = torch.from_numpy(np.ascontiguousarray(images[sel])).to(dev)
        out[torch.from_numpy(sel).to(dev)] = weights_fn(frames, sel).to(
            torch.float16)
    return out.cpu().numpy()


def compute_ist(dataset, batch: Dict, ist_range: float, split: str,
                offline: bool = False, device=None) -> Optional[np.ndarray]:
    """IST weights of a cached image batch.

    Args:
        batch: {"image": [B, H, W, 3] float32, "image_idx": [B] int}.
        device: where the weights are computed (default CUDA).
    Returns:
        [B, H, W] float16, or None for cameras without times.
    """
    cameras = dataset.cameras
    if cameras.times is None:
        return None
    images = np.asarray(batch["image"])
    B, H = images.shape[:2]
    rng_str = str(ist_range).replace(".", "_")
    cache = _cache_path(dataset, f"ist-weights-{rng_str}-{split}-{B}-{H}p.npy")
    if offline:
        cached = _try_load_cache(cache, B)
        if cached is not None:
            return cached

    img_idx = np.asarray(batch["image_idx"])
    cam_times = cameras.times.cpu().numpy()[img_idx]
    dev = resolve_device(device)

    def weights(frames, sel):
        t = cam_times[sel]
        dt = np.abs(t[:, None] - t[None, :])
        close = torch.from_numpy((dt <= ist_range) & (dt > 0.01)).to(dev)
        return ist_weights(frames, close)

    out = _per_camera(images, _cam_ids(cameras, img_idx), dev, weights)
    if offline:
        np.save(cache, out)
    return out


def compute_isg(dataset, batch: Dict, gamma: float, split: str,
                offline: bool = False, device=None) -> Optional[np.ndarray]:
    """ISG weights of a cached image batch ([B, H, W] float16, or None for
    cameras without times)."""
    cameras = dataset.cameras
    if cameras.times is None:
        return None
    images = np.asarray(batch["image"])
    B, H = images.shape[:2]
    cache = _cache_path(dataset, f"isg-weights-{gamma}-{split}-{B}-{H}p.npy")
    if offline:
        cached = _try_load_cache(cache, B)
        if cached is not None:
            return cached
    img_idx = np.asarray(batch["image_idx"])
    out = _per_camera(images, _cam_ids(cameras, img_idx), device,
                      lambda frames, sel: isg_weights(frames, gamma))
    if offline:
        np.save(cache, out)
    return out


def compute_iss(dataset, batch: Dict, split: str, offline: bool = False
                ) -> np.ndarray:
    """Static-scene ISS: detection boxes -> binary weight maps, [B, H, W]
    float16.  No detector is loaded (its weights are not in the
    repository), so every image gets uniform 1s, the JAX package's branch
    for an image without detections."""
    images = np.asarray(batch["image"])
    B, H, W = images.shape[:3]
    cache = _cache_path(dataset, f"iss-weights-{split}-{B}-{H}p.npy")
    if offline:
        cached = _try_load_cache(cache, B)
        if cached is not None:
            return cached
    out = np.ones((B, H, W), dtype=np.float16)
    if offline:
        np.save(cache, out)
    return out
