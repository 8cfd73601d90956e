"""In-RAM image batch cache with resampling (counterpart of
soccernerfs_tpu/data/image_cache.py).

Holds N decoded images, picks a new set every ``num_times_to_repeat_images``
iterations (pick modes normal / randsteps / lowfps), decodes in a thread
pool and attaches importance weights and the running iteration count.
The picks draw from a ``random.Random`` the caller hands in: the JAX cache
draws from the global ``random`` module, which its trainer seeds with the
same seed, so both pick the same images.
"""
from __future__ import annotations

import concurrent.futures
import os
import random
from math import ceil
from typing import Dict, List, Optional

import numpy as np

from soccernerfs_tpu_torch.data.datasets import DynamicDataset, InputDataset


class ImageBatchCache:
    def __init__(
        self,
        dataset: InputDataset,
        num_images_to_sample_from: int = -1,
        num_times_to_repeat_images: int = -1,
        num_workers: int = 4,
        rng: Optional[random.Random] = None,
    ):
        self.dataset = dataset
        self.rng = rng if rng is not None else random.Random()
        self.cache_all = (
            num_images_to_sample_from == -1
            or num_images_to_sample_from >= len(dataset)
        )
        self.num_images_to_sample_from = (
            len(dataset) if self.cache_all else num_images_to_sample_from
        )
        self.num_times_to_repeat_images = num_times_to_repeat_images
        self.num_workers = num_workers

        self.num_repeated = num_times_to_repeat_images
        self.first_time = True
        self.iter_step = 0
        self.cached_batch: Optional[Dict] = None

        if self.cache_all:
            self.cached_batch = self._collate()
            if self._is_dynamic_with_is():
                self.cached_batch["ist_weights"] = self.dataset.compute_is(
                    self.cached_batch, offline=True
                )

    def _is_dynamic_with_is(self) -> bool:
        return (
            isinstance(self.dataset, DynamicDataset)
            and self.dataset.is_config.use_importance_sampling
        )

    def _pick_indices(self) -> List[int]:
        """The normal / randsteps / lowfps image-set selection."""
        total = len(self.dataset)
        to_sample = self.num_images_to_sample_from
        pick_mode = "normal"
        if isinstance(self.dataset, DynamicDataset):
            pick_mode = self.dataset.is_config.pick_mode
        if total == to_sample:
            pick_mode = "normal"

        if pick_mode == "normal":
            return self.rng.sample(range(total), k=to_sample)

        times_arr = self.dataset.cameras.times.cpu().numpy()
        times = sorted(set(times_arr.tolist()))
        if pick_mode == "randsteps":
            ids = self.dataset.cameras.ids
            nb_unique_cams = 1 if ids is None else len(set(ids.tolist()))
            steps_to_pick = int(to_sample / nb_unique_cams)
            picked = [times[0], times[-1]]
            if steps_to_pick > 2:
                picked += self.rng.sample(times[1:-1], k=steps_to_pick - 2)
        elif pick_mode == "lowfps":
            k = ceil(total / to_sample)
            picked = times[::k]
            if len(times) % k != 0:
                picked = picked[:-1]
        else:
            raise ValueError(f"unknown pick_mode {pick_mode}")

        picked_set = set(picked)
        indices = [i for i in range(total) if float(times_arr[i]) in picked_set]
        left = to_sample - len(indices)
        if left > 0:
            pool = [i for i in range(total) if i not in set(indices)]
            indices += self.rng.sample(pool, k=left)
        elif left < 0:
            indices = indices[:to_sample]
        if len(indices) != to_sample:
            raise RuntimeError("not enough images to sample from")
        return indices

    def _collate(self) -> Dict:
        """Decode the picked images in a thread pool and stack them."""
        indices = (
            list(range(len(self.dataset))) if self.cache_all else self._pick_indices()
        )
        workers = max(1, min(self.num_workers * 4, (os.cpu_count() or 2) - 1))
        with concurrent.futures.ThreadPoolExecutor(max_workers=workers) as ex:
            items = list(ex.map(self.dataset.__getitem__, indices))
        batch = {
            "image_idx": np.asarray([it["image_idx"] for it in items], np.int64),
            "image": np.stack([it["image"] for it in items]),
        }
        for key in ("mask", "depth_image", "semantics"):
            if key in items[0]:
                batch[key] = np.stack([it[key] for it in items])
        return batch

    def next_batch(self) -> Dict:
        """The cached batch of this iteration, picked and decoded anew every
        ``num_times_to_repeat_images`` iterations; importance weights are
        attached at a refresh once ``iter_step + repeat`` reaches
        ``iters_to_start_is``."""
        if self.cache_all:
            batch = self.cached_batch
        elif self.first_time or (
            self.num_times_to_repeat_images != -1
            and self.num_repeated >= self.num_times_to_repeat_images
        ):
            self.num_repeated = 0
            batch = self._collate()
            if self._is_dynamic_with_is():
                iters_to_start = self.dataset.is_config.iters_to_start_is
                if self.iter_step + self.num_times_to_repeat_images >= iters_to_start:
                    batch["ist_weights"] = self.dataset.compute_is(batch)
            self.cached_batch = (
                batch if self.num_times_to_repeat_images != 0 else None
            )
            self.first_time = False
        else:
            batch = self.cached_batch
            self.num_repeated += 1
        self.iter_step += 1
        batch["iter_steps"] = self.iter_step
        return batch
