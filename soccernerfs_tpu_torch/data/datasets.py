"""Datasets: host-side image access (counterpart of
soccernerfs_tpu/data/datasets.py).

Images load to float32 numpy [H, W, 3] in [0, 1]; RGBA composites over
the dataparser's alpha colour.  The dynamic dataset adds the IST/ISG/ISS
importance weights, computed in torch on its device
(``data/importance.py``).  Depth maps wait for the depth loss.
"""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
from PIL import Image

from soccernerfs_tpu_torch.data import importance
from soccernerfs_tpu_torch.data.dataparsers.base import DataparserOutputs


def get_image(filename: Path, scale_factor: float = 1.0, alpha_color=None
              ) -> np.ndarray:
    """An image as float32 [H, W, 3] in [0, 1]; RGBA composited over
    ``alpha_color`` (white when None)."""
    pil_image = Image.open(filename)
    if scale_factor != 1.0:
        w, h = pil_image.size
        pil_image = pil_image.resize(
            (int(w * scale_factor), int(h * scale_factor)), resample=Image.BILINEAR)
    image = np.asarray(pil_image, dtype=np.uint8).astype(np.float32) / 255.0
    if image.ndim == 2:
        image = np.repeat(image[..., None], 3, axis=-1)
    if image.shape[-1] == 4:
        alpha = image[..., -1:]
        rgb = image[..., :3]
        if alpha_color is not None:
            image = rgb * alpha + np.asarray(alpha_color, np.float32) * (1.0 - alpha)
        else:
            image = rgb * alpha + (1.0 - alpha)
    return image[..., :3]


def get_mask(filename: Path, scale_factor: float = 1.0) -> np.ndarray:
    """Boolean [H, W] mask."""
    pil_mask = Image.open(filename)
    if scale_factor != 1.0:
        w, h = pil_mask.size
        pil_mask = pil_mask.resize(
            (int(w * scale_factor), int(h * scale_factor)), resample=Image.NEAREST)
    mask = np.asarray(pil_mask)
    if mask.ndim == 3:
        mask = mask[..., 0]
    return mask > 0


class InputDataset:
    """Index-addressable image dataset."""

    def __init__(self, dataparser_outputs: DataparserOutputs,
                 scale_factor: float = 1.0):
        self._dataparser_outputs = dataparser_outputs
        self.scale_factor = scale_factor
        self.cameras = dataparser_outputs.cameras
        self.scene_box = dataparser_outputs.scene_box
        self.metadata = dataparser_outputs.metadata
        self.alpha_color = dataparser_outputs.alpha_color

    def __len__(self) -> int:
        return len(self._dataparser_outputs.image_filenames)

    @property
    def image_filenames(self) -> List[Path]:
        return self._dataparser_outputs.image_filenames

    def get_image(self, image_idx: int) -> np.ndarray:
        return get_image(self.image_filenames[image_idx], self.scale_factor,
                         self.alpha_color)

    def __getitem__(self, image_idx: int) -> Dict:
        data = {"image_idx": image_idx, "image": self.get_image(image_idx)}
        if self._dataparser_outputs.mask_filenames is not None:
            data["mask"] = get_mask(
                self._dataparser_outputs.mask_filenames[image_idx],
                self.scale_factor)
        return data


@dataclass
class ImportanceSamplingConfig:
    """The fork's importance-sampling options."""

    use_importance_sampling: bool = True
    is_pixel_ratio: float = 0.03
    ist_range: float = 0.25
    iters_to_start_is: int = 2000
    isg: bool = False
    isg_gamma: float = 5e-2
    pick_mode: str = "randsteps"  # normal | randsteps | lowfps


class DynamicDataset(InputDataset):
    """InputDataset + importance-sampling weights, computed on ``device``
    (default CUDA)."""

    def __init__(
        self,
        dataparser_outputs: DataparserOutputs,
        scale_factor: float = 1.0,
        is_config: Optional[ImportanceSamplingConfig] = None,
        eval_dataset: bool = False,
        device=None,
    ):
        super().__init__(dataparser_outputs, scale_factor)
        if dataparser_outputs.metadata.get("depth_filenames"):
            raise NotImplementedError(
                "depth maps feed the DS-NeRF depth loss, which the port does "
                "not have yet; parse with depth_maps='none'")
        self.is_config = is_config or ImportanceSamplingConfig()
        self.eval_dataset = eval_dataset
        self.device = device

    @property
    def static(self) -> bool:
        return bool(self.metadata.get("static", False))

    def compute_is(self, batch: Dict, offline: bool = False) -> Optional[np.ndarray]:
        """Static ISS, ISG or IST weights of ``batch``: [B, H, W] float16
        or None."""
        split = "eval" if self.eval_dataset else "train"
        if self.static:
            return importance.compute_iss(self, batch, split=split, offline=offline)
        if self.is_config.isg:
            return importance.compute_isg(
                self, batch, gamma=self.is_config.isg_gamma, split=split,
                offline=offline, device=self.device)
        return importance.compute_ist(
            self, batch, ist_range=self.is_config.ist_range, split=split,
            offline=offline, device=self.device)
