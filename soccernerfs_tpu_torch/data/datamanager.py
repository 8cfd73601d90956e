"""DataManagers (counterpart of soccernerfs_tpu/data/datamanager.py).

The datamanager runs on the host: image cache, pixel sampling, batch
assembly; it yields fixed-shape numpy arrays (camera index, pixel, colour).
The trainer generates the rays inside its step; ``rays_for`` /
``next_train`` give the (RayBundle, batch) surface for other callers, the
rays on the datamanager's device.
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from soccernerfs_tpu_torch.core.camera_optimizer import CameraOptimizerConfig
from soccernerfs_tpu_torch.core.cameras import (
    Cameras,
    CameraType,
    generate_image_rays,
    generate_rays,
)
from soccernerfs_tpu_torch.core.rays import RayBundle
from soccernerfs_tpu_torch.data.dataparsers.base import DataParserConfig
from soccernerfs_tpu_torch.data.datasets import (
    DynamicDataset,
    ImportanceSamplingConfig,
    InputDataset,
)
from soccernerfs_tpu_torch.data.image_cache import ImageBatchCache
from soccernerfs_tpu_torch.data.pixel_samplers import (
    DynamicBasedPixelSampler,
    EquirectangularPixelSampler,
    PixelSampler,
)
from soccernerfs_tpu_torch.utils.device import resolve_device


@dataclass
class VanillaDataManagerConfig:
    dataparser: Optional[DataParserConfig] = None
    train_num_rays_per_batch: int = 1024
    train_num_images_to_sample_from: int = -1
    train_num_times_to_repeat_images: int = -1
    eval_num_rays_per_batch: int = 1024
    eval_num_images_to_sample_from: int = -1
    eval_num_times_to_repeat_images: int = -1
    eval_image_indices: Tuple[int, ...] = (0,)
    camera_optimizer: CameraOptimizerConfig = field(default_factory=CameraOptimizerConfig)
    camera_res_scale_factor: float = 1.0

    def setup(self, **kwargs) -> "VanillaDataManager":
        return VanillaDataManager(self, **kwargs)


@dataclass
class DynamicDataManagerConfig(VanillaDataManagerConfig):
    """The fork's datamanager with its importance-sampling options."""

    use_importance_sampling: bool = True
    is_pixel_ratio: float = 0.03
    ist_range: float = 0.25
    iters_to_start_is: int = 2000
    isg: bool = False
    isg_gamma: float = 5e-2
    pick_mode: str = "randsteps"

    def setup(self, **kwargs) -> "DynamicDataManager":
        return DynamicDataManager(self, **kwargs)


class VanillaDataManager:
    """Train and eval datasets, image caches and pixel samplers.

    Args:
        seed: seeds the pixel samplers (numpy) and the caches' picks (one
            ``random.Random`` shared by both caches, in the order the JAX
            package's caches draw from the global ``random``).
        device: where rays and importance weights are computed (default
            CUDA; raises when CUDA is absent and the caller did not ask
            for another device).
    """

    dataset_cls = InputDataset

    def __init__(self, config: VanillaDataManagerConfig, test_mode: str = "val",
                 seed=None, device=None):
        self.config = config
        self.test_mode = test_mode
        self.device = resolve_device(device)
        self.eval_split = "test" if test_mode in ("test", "inference") else "val"
        if config.dataparser is None:
            raise ValueError("the datamanager config has no dataparser: set one "
                             "of data.dataparsers.DATAPARSERS")
        self.dataparser = config.dataparser.setup()

        self.train_dataparser_outputs = self.dataparser.get_dataparser_outputs("train")
        self.train_dataset = self._make_dataset(self.train_dataparser_outputs, eval=False)
        self.eval_dataparser_outputs = self.dataparser.get_dataparser_outputs(self.eval_split)
        self.eval_dataset = self._make_dataset(self.eval_dataparser_outputs, eval=True)
        self.train_cameras: Cameras = self.train_dataparser_outputs.cameras.to(self.device)
        self.eval_cameras: Cameras = self.eval_dataparser_outputs.cameras.to(self.device)

        picks = random.Random(seed)
        self.train_cache = ImageBatchCache(
            self.train_dataset,
            config.train_num_images_to_sample_from,
            config.train_num_times_to_repeat_images,
            rng=picks,
        )
        self.eval_cache = ImageBatchCache(
            self.eval_dataset,
            config.eval_num_images_to_sample_from,
            config.eval_num_times_to_repeat_images,
            rng=picks,
        )
        self.train_pixel_sampler = self._make_pixel_sampler(
            self.train_dataset, config.train_num_rays_per_batch, seed
        )
        self.eval_pixel_sampler = self._make_pixel_sampler(
            self.eval_dataset, config.eval_num_rays_per_batch, seed
        )

    def _make_dataset(self, outputs, eval: bool) -> InputDataset:
        return self.dataset_cls(outputs, self.config.camera_res_scale_factor)

    def _make_pixel_sampler(self, dataset, num_rays, seed) -> PixelSampler:
        if bool(torch.all(dataset.cameras.camera_type
                          == int(CameraType.EQUIRECTANGULAR))):
            return EquirectangularPixelSampler(num_rays, seed=seed)
        return PixelSampler(num_rays, seed=seed)

    def next_train_raw(self, step: int) -> Dict:
        """Host-side pixel batch: indices [N, 3] (camera, row, col) and
        image [N, 3], numpy."""
        image_batch = self.train_cache.next_batch()
        return self.train_pixel_sampler.sample(image_batch)

    def next_eval_raw(self, step: int) -> Dict:
        image_batch = self.eval_cache.next_batch()
        return self.eval_pixel_sampler.sample(image_batch)

    def rays_for(self, batch: Dict, cameras: Cameras,
                 camera_opt_to_camera=None) -> RayBundle:
        """A pixel batch's rays, on the cameras' device."""
        indices = torch.from_numpy(np.asarray(batch["indices"])).to(
            cameras.camera_to_worlds.device)
        coords = indices[:, 1:].float() + 0.5
        cam_idx = indices[:, 0].to(torch.int32)
        return generate_rays(cameras, cam_idx, coords, camera_opt_to_camera)

    def next_train(self, step: int) -> Tuple[RayBundle, Dict]:
        batch = self.next_train_raw(step)
        return self.rays_for(batch, self.train_cameras), batch

    def next_eval_image(self, idx: int) -> Tuple[int, RayBundle, Dict]:
        """Eval image ``idx`` (modulo their count): its rays and its
        {"image", "image_idx"}."""
        idx = int(idx % len(self.eval_dataset))
        ray_bundle = generate_image_rays(self.eval_cameras, idx)
        data = self.eval_dataset[idx]
        return idx, ray_bundle, {"image": data["image"], "image_idx": idx}

    def get_train_rays_per_batch(self) -> int:
        return self.config.train_num_rays_per_batch


class DynamicDataManager(VanillaDataManager):
    """The dynamic dataset and the importance sampler."""

    dataset_cls = DynamicDataset

    def _is_config(self) -> ImportanceSamplingConfig:
        c = self.config
        return ImportanceSamplingConfig(
            use_importance_sampling=c.use_importance_sampling,
            is_pixel_ratio=c.is_pixel_ratio,
            ist_range=c.ist_range,
            iters_to_start_is=c.iters_to_start_is,
            isg=c.isg,
            isg_gamma=c.isg_gamma,
            pick_mode=c.pick_mode,
        )

    def _make_dataset(self, outputs, eval: bool) -> DynamicDataset:
        return DynamicDataset(
            outputs,
            self.config.camera_res_scale_factor,
            is_config=self._is_config(),
            eval_dataset=eval,
            device=self.device,
        )

    def _make_pixel_sampler(self, dataset, num_rays, seed) -> PixelSampler:
        if self.config.use_importance_sampling:
            return DynamicBasedPixelSampler(
                num_rays,
                is_pixel_ratio=self.config.is_pixel_ratio,
                iters_to_start_is=self.config.iters_to_start_is,
                seed=seed,
            )
        return super()._make_pixel_sampler(dataset, num_rays, seed)
