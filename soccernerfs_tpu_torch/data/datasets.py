"""Datasets: host-side image access (counterpart of
soccernerfs_tpu/data/datasets.py).

Images load to float32 numpy [H, W, 3] in [0, 1]; RGBA composites over
the dataparser's alpha colour.  The dynamic dataset adds depth maps (the
depth losses' targets) and the IST/ISG/ISS importance weights, computed
in torch on its device (``data/importance.py``); the semantic dataset
adds per-pixel class labels.
"""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch
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


def get_depth_image_from_path(filepath: Path, height: int, width: int,
                              scale_factor: float) -> np.ndarray:
    """A depth map as float32 [height, width] in the scene's units: a
    ``.npy`` array or an image (16-bit PNG, mode I, ...), times
    ``scale_factor``, resized to the camera's size (nearest, in Pillow's
    float mode)."""
    if filepath.suffix == ".npy":
        depth = np.load(filepath).astype(np.float64) * scale_factor
    else:
        with Image.open(filepath) as image:
            depth = np.asarray(image).astype(np.float64) * scale_factor
    image = Image.fromarray(depth).resize((width, height), resample=Image.NEAREST)
    out = np.asarray(image, dtype=np.float32)
    return out[..., 0] if out.ndim == 3 else out


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

    def get_metadata(self, data: Dict) -> Dict:
        """What a subclass adds to an item beside its image and mask, from
        ``data["image_idx"]``."""
        return {}

    def get_extras(self, image_idx: int) -> Dict:
        """An item's mask and metadata, without its image."""
        data = {"image_idx": image_idx}
        if self._dataparser_outputs.mask_filenames is not None:
            data["mask"] = get_mask(
                self._dataparser_outputs.mask_filenames[image_idx],
                self.scale_factor)
        data.update(self.get_metadata(data))
        return data

    def __getitem__(self, image_idx: int) -> Dict:
        data = {"image_idx": image_idx, "image": self.get_image(image_idx)}
        data.update(self.get_extras(image_idx))
        return data


class SemanticDataset(InputDataset):
    """InputDataset + per-pixel semantic labels, from the files, classes
    and colours of the dataparser's ``semantics`` metadata."""

    def __init__(self, dataparser_outputs: DataparserOutputs,
                 scale_factor: float = 1.0):
        super().__init__(dataparser_outputs, scale_factor)
        sem = dataparser_outputs.metadata.get("semantics")
        if sem is None:
            raise ValueError("SemanticDataset needs the parser's semantics "
                             "metadata (include_semantics)")
        self.semantic_filenames = sem["filenames"]
        self.semantic_classes = sem["classes"]
        self.semantic_colors = sem["colors"]

    def get_metadata(self, data: Dict) -> Dict:
        """The item's "semantics" [H, W] int32: the label image read with
        Pillow, resized nearest at the scale factor, its first channel
        where it has several."""
        sem = Image.open(self.semantic_filenames[data["image_idx"]])
        if self.scale_factor != 1.0:
            w, h = sem.size
            sem = sem.resize(
                (int(w * self.scale_factor), int(h * self.scale_factor)),
                resample=Image.NEAREST)
        labels = np.asarray(sem)
        if labels.ndim == 3:
            labels = labels[..., 0]
        return {"semantics": labels.astype(np.int32)}


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
    """InputDataset + depth maps (when the parser names depth files) +
    importance-sampling weights, computed on ``device`` (default CUDA)."""

    def __init__(
        self,
        dataparser_outputs: DataparserOutputs,
        scale_factor: float = 1.0,
        is_config: Optional[ImportanceSamplingConfig] = None,
        eval_dataset: bool = False,
        device=None,
    ):
        super().__init__(dataparser_outputs, scale_factor)
        self.is_config = is_config or ImportanceSamplingConfig()
        self.eval_dataset = eval_dataset
        self.device = device
        self.depth_enabled = bool(self.metadata.get("depth_filenames"))
        if self.depth_enabled:
            self.depth_filenames = self.metadata["depth_filenames"]
            self.depth_unit_scale_factor = self.metadata["depth_unit_scale_factor"]

    @property
    def static(self) -> bool:
        return bool(self.metadata.get("static", False))

    def get_metadata(self, data: Dict) -> Dict:
        """The item's "depth_image" [H, W] at its camera's size, in the
        scene's units (``depth_unit_scale_factor`` times the parser's
        scale), when the parser names depth files."""
        if not self.depth_enabled:
            return {}
        idx = data["image_idx"]
        scale = (self.depth_unit_scale_factor
                 * self._dataparser_outputs.dataparser_scale)
        return {"depth_image": get_depth_image_from_path(
            self.depth_filenames[idx], int(self.cameras.height[idx]),
            int(self.cameras.width[idx]), scale)}

    def importance_maps(self, batch: Dict, offline: bool = False
                        ) -> Optional[torch.Tensor]:
        """Static ISS, ISG or IST weights of ``batch``: [B, H, W] float16
        on the dataset's device (where the importance sampler draws from
        them), or None."""
        split = "eval" if self.eval_dataset else "train"
        if self.static:
            return importance.iss_maps(self, batch, split=split,
                                       offline=offline, device=self.device)
        if self.is_config.isg:
            return importance.isg_maps(
                self, batch, gamma=self.is_config.isg_gamma, split=split,
                offline=offline, device=self.device)
        return importance.ist_maps(
            self, batch, ist_range=self.is_config.ist_range, split=split,
            offline=offline, device=self.device)
