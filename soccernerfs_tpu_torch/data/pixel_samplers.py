"""Pixel samplers (counterpart of soccernerfs_tpu/data/pixel_samplers.py).

Host-side numpy samplers: each step they pick (image, row, col) indices
from the cached image batch and gather the supervision values.  Each draws
from its own ``numpy.random.Generator(seed)``, so a seed gives the JAX
package's indices.  The importance sampler (``DynamicBasedPixelSampler``,
over IST/ISG weight maps) keeps the fork's semantics: ratio split,
10x-ceil per-image cap, shuffled image order, empty-map skip,
with-replacement fallback for tiny supports, uniform remainder.  Its
draws are the JAX package's C++ sampler's, draw for draw
(``native_loader.weighted_samples``: one scan and one draw launch a step
on the maps' device), or numpy's ``choice``, JAX's path without its
library, where a test turns ``native_loader.available`` off.
"""
from __future__ import annotations

from dataclasses import dataclass
from math import ceil, floor
from typing import Dict, Optional

import numpy as np
import torch

from soccernerfs_tpu_torch.data import native_loader


@dataclass
class PixelSamplerConfig:
    num_rays_per_batch: int = 4096
    keep_full_image: bool = False


class PixelSampler:
    """Uniform pixel sampler."""

    def __init__(self, num_rays_per_batch: int, keep_full_image: bool = False, **kwargs):
        self.num_rays_per_batch = num_rays_per_batch
        self.keep_full_image = keep_full_image
        self.kwargs = kwargs
        self.rng = np.random.default_rng(kwargs.get("seed"))

    def set_num_rays_per_batch(self, num_rays_per_batch: int):
        self.num_rays_per_batch = num_rays_per_batch

    def sample_method(
        self,
        batch_size: int,
        num_images: int,
        image_height: int,
        image_width: int,
        mask: Optional[np.ndarray] = None,
        batch: Optional[Dict] = None,
    ) -> np.ndarray:
        """[batch_size, 3] (image, row, col) indices; respects a boolean
        mask when given (ref: pixel_samplers.py:51-78)."""
        if mask is not None:
            nonzero = np.argwhere(mask)
            chosen = self.rng.choice(len(nonzero), size=batch_size, replace=False)
            return nonzero[chosen]
        u = self.rng.random((batch_size, 3))
        return np.floor(
            u * np.array([num_images, image_height, image_width])
        ).astype(np.int64)

    def sample(self, image_batch: Dict) -> Dict:
        """Collate a pixel batch from an image batch
        (ref: pixel_samplers.py:81-128 collate_image_dataset_batch)."""
        images = image_batch["image"]  # [N, H, W, 3]
        num_images, image_height, image_width = images.shape[:3]
        indices = self.sample_method(
            self.num_rays_per_batch,
            num_images,
            image_height,
            image_width,
            mask=image_batch.get("mask"),
            batch=image_batch,
        )
        c, y, x = indices[:, 0], indices[:, 1], indices[:, 2]
        collated = {
            key: value[c, y, x]
            for key, value in image_batch.items()
            if key not in ("image_idx", "iter_steps", "ist_weights") and value is not None
            and hasattr(value, "ndim") and value.ndim >= 3
        }
        collated["image"] = images[c, y, x]
        if "depth_image" in image_batch and image_batch["depth_image"] is not None:
            collated["depth_image"] = image_batch["depth_image"][c, y, x]
        # translate cache-local image slots to dataset camera indices
        abs_indices = indices.copy()
        abs_indices[:, 0] = np.asarray(image_batch["image_idx"])[c]
        collated["indices"] = abs_indices
        if self.keep_full_image:
            collated["full_image"] = images
        return collated


class EquirectangularPixelSampler(PixelSampler):
    """Latitude-weighted sampling for 360 images
    (ref: pixel_samplers.py:228-268): rows drawn via inverse-cos warp so
    pixel density matches solid angle."""

    def sample_method(
        self, batch_size, num_images, image_height, image_width, mask=None, batch=None
    ) -> np.ndarray:
        if mask is not None:
            return super().sample_method(
                batch_size, num_images, image_height, image_width, mask=mask
            )
        num_rays = self.rng.integers(0, num_images, (batch_size,))
        phi = np.arccos(1.0 - 2.0 * self.rng.random((batch_size,)))
        phi = (phi / np.pi * image_height).astype(np.int64)
        theta = (self.rng.random((batch_size,)) * image_width).astype(np.int64)
        return np.stack(
            [num_rays, np.clip(phi, 0, image_height - 1), theta], axis=-1
        )


class PatchPixelSampler(PixelSampler):
    """Samples patch_size x patch_size blocks (ref: pixel_samplers.py:270-327)."""

    def __init__(self, num_rays_per_batch, keep_full_image=False, patch_size: int = 32, **kw):
        super().__init__(num_rays_per_batch, keep_full_image, **kw)
        self.patch_size = patch_size

    def sample_method(
        self, batch_size, num_images, image_height, image_width, mask=None, batch=None
    ) -> np.ndarray:
        ps = self.patch_size
        num_patches = batch_size // (ps * ps)
        c = self.rng.integers(0, num_images, (num_patches,))
        y0 = self.rng.integers(0, max(image_height - ps, 1), (num_patches,))
        x0 = self.rng.integers(0, max(image_width - ps, 1), (num_patches,))
        dy, dx = np.meshgrid(np.arange(ps), np.arange(ps), indexing="ij")
        cc = np.repeat(c, ps * ps)
        yy = (y0[:, None, None] + dy[None]).reshape(-1)
        xx = (x0[:, None, None] + dx[None]).reshape(-1)
        return np.stack([cc, yy, xx], axis=-1)


class DynamicBasedPixelSampler(PixelSampler):
    """Hybrid importance/uniform sampler over IST weight maps
    (ref: pixel_samplers.py:329-427)."""

    def __init__(
        self,
        num_rays_per_batch: int,
        keep_full_image: bool = False,
        is_pixel_ratio: float = 0.03,
        iters_to_start_is: int = 2000,
        **kwargs,
    ):
        super().__init__(num_rays_per_batch, keep_full_image, **kwargs)
        self.is_pixel_ratio = is_pixel_ratio
        self.iters_to_start_is = iters_to_start_is
        self._staged_from = None

    def sample_method(
        self, batch_size, num_images, image_height, image_width, mask=None, batch=None
    ) -> np.ndarray:
        assert batch is not None
        ist_weights = batch.get("ist_weights")
        iter_steps = batch.get("iter_steps", 0)
        use_ist = ist_weights is not None and iter_steps > self.iters_to_start_is
        if not use_ist:
            return super().sample_method(
                batch_size, num_images, image_height, image_width, mask=mask
            )

        num_ist = floor(self.is_pixel_ratio * batch_size)
        per_image_cap = 10 * ceil(num_ist / num_images)

        # the visited images, their sample counts and replacement; the
        # maps are not read here (their supports come once per refresh)
        maps, support = self._staged(ist_weights)
        visits = []
        sampled = 0
        order = self.rng.permutation(num_images)
        for i in order:
            if sampled >= num_ist:
                break
            if support[i] == 0:
                continue  # motionless camera: empty map, skip
            num_samples = min(per_image_cap, num_ist - sampled)
            visits.append((int(i), num_samples, bool(support[i] < num_samples)))
            sampled += num_samples

        if not visits:
            ist_indices = np.zeros((0, 3), dtype=np.int64)
        else:
            ids, ks, replaces = (list(v) for v in zip(*visits))
            if native_loader.available():
                seeds = [int(self.rng.integers(0, 2**62)) for _ in visits]
                flat = native_loader.weighted_samples(maps, ids, ks, replaces,
                                                      seeds)
            else:
                flat = np.concatenate([
                    self._weighted_choice(ist_weights, i, k, r)
                    for i, k, r in visits])
            ist_indices = np.stack([np.repeat(ids, ks), flat // image_width,
                                    flat % image_width], axis=-1)
        num_unif = batch_size - ist_indices.shape[0]
        unif = super().sample_method(
            num_unif, num_images, image_height, image_width, mask=mask
        )
        return np.concatenate([ist_indices.astype(np.int64), unif], axis=0)

    def _staged(self, ist_weights):
        """(maps [B, H*W] tensor, support [B] numpy): the weight maps where
        the cache staged them (a numpy batch's on the CPU) and each map's
        count of nonzero cells, counted on the maps' device once per map
        set and read back once.  The weights are non-negative: a map
        without support is a map whose total is 0."""
        if ist_weights is not self._staged_from:
            maps = (ist_weights if torch.is_tensor(ist_weights)
                    else torch.from_numpy(np.ascontiguousarray(ist_weights)))
            maps = maps.reshape(maps.shape[0], -1)
            self._staged_from = ist_weights
            self._maps = maps
            self._support = torch.count_nonzero(maps, dim=1).cpu().numpy()
        return self._maps, self._support

    def _weighted_choice(self, ist_weights, i, num_samples, replace):
        """numpy's weighted draw from map i, the JAX package's draw where
        its C++ loader library is absent (read on the host)."""
        weight_map = np.asarray(ist_weights[i], dtype=np.float64)
        total = weight_map.sum()
        flat = weight_map.reshape(-1)
        return self.rng.choice(
            flat.size, size=num_samples, replace=replace, p=flat / total
        )
