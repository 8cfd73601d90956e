"""The generic nerfstudio-format dataparser (counterpart of
soccernerfs_tpu/data/dataparsers/nerfstudio_parser.py).

``transforms.json`` with global or per-frame intrinsics and distortion,
optional masks and depth maps, a fraction split with equally spaced train
frames, orientation and centring, auto-scaling, and ``images_{k}/``,
``masks_{k}/`` and ``depths_{k}/`` downscale directories (the soccer
scenes use ``{k}x/``).  Its cameras have no times.
"""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path, PurePath
from typing import Optional

import numpy as np
import torch

from soccernerfs_tpu_torch.core.cameras import (
    CAMERA_MODEL_TO_TYPE,
    Cameras,
    CameraType,
)
from soccernerfs_tpu_torch.core.pose_utils import auto_orient_and_center_poses
from soccernerfs_tpu_torch.core.scene_box import SceneBox
from soccernerfs_tpu_torch.data.dataparsers.base import (
    DataParser,
    DataParserConfig,
    DataparserOutputs,
    load_from_json,
)

_INTRINSICS = ("fl_x", "fl_y", "cx", "cy", "h", "w")
_DISTORTION = ("k1", "k2", "k3", "k4", "p1", "p2")


@dataclass
class NerfstudioDataParserConfig(DataParserConfig):
    data: Path = Path("data/nerfstudio/poster")
    scale_factor: float = 1.0
    downscale_factor: Optional[int] = None
    scene_scale: float = 1.0
    orientation_method: str = "up"
    center_method: str = "poses"
    auto_scale_poses: bool = True
    train_split_fraction: float = 0.9
    depth_unit_scale_factor: float = 1e-3

    def setup(self):
        return Nerfstudio(self)


class Nerfstudio(DataParser):
    """A nerfstudio ``transforms.json`` (``data`` names it or its
    directory); frames whose image is missing are skipped."""

    def __init__(self, config: NerfstudioDataParserConfig):
        super().__init__(config)

    def _get_fname(self, filepath: PurePath, data_dir: Path,
                   prefix: str = "images_") -> Path:
        ds = self.config.downscale_factor
        if ds is None or ds <= 1:
            return data_dir / filepath
        return data_dir / f"{prefix}{ds}" / Path(filepath).name

    def _generate_dataparser_outputs(self, split="train") -> DataparserOutputs:
        config = self.config
        data = Path(config.data)
        meta = load_from_json(data if data.suffix == ".json"
                              else data / "transforms.json")
        data_dir = data.parent if data.suffix == ".json" else data

        fixed = {k: k in meta for k in _INTRINSICS}
        distort_fixed = any(k in meta for k in ("k1", "k2", "k3", "p1", "p2"))
        per_frame = {k: [] for k in _INTRINSICS}
        image_filenames, mask_filenames, depth_filenames = [], [], []
        poses, distort = [], []
        for frame in meta["frames"]:
            fname = self._get_fname(PurePath(frame["file_path"]), data_dir)
            if not fname.exists():
                continue
            for key, values in per_frame.items():
                if not fixed[key]:
                    values.append((int if key in ("h", "w") else float)(frame[key]))
            if not distort_fixed:
                distort.append([float(frame.get(k, 0.0)) for k in _DISTORTION])
            image_filenames.append(fname)
            poses.append(np.array(frame["transform_matrix"], dtype=np.float64))
            if "mask_path" in frame:
                mask_filenames.append(self._get_fname(
                    PurePath(frame["mask_path"]), data_dir, prefix="masks_"))
            if "depth_file_path" in frame:
                depth_filenames.append(self._get_fname(
                    PurePath(frame["depth_file_path"]), data_dir,
                    prefix="depths_"))
        if not image_filenames:
            raise ValueError(f"no images found under {data_dir}")

        # the fraction split, train frames equally spaced
        num_images = len(image_filenames)
        num_train = int(np.ceil(num_images * config.train_split_fraction))
        i_train = np.linspace(0, num_images - 1, num_train, dtype=int)
        i_eval = np.setdiff1d(np.arange(num_images), i_train)
        indices = i_train if split == "train" else i_eval

        poses, transform_matrix = auto_orient_and_center_poses(
            np.stack(poses).astype(np.float32),
            method=meta.get("orientation_override", config.orientation_method),
            center_method=config.center_method)
        scale_factor = 1.0
        if config.auto_scale_poses:
            scale_factor /= float(np.max(np.abs(poses[:, :3, 3])))
        scale_factor *= config.scale_factor
        poses[:, :3, 3] *= scale_factor

        def gather(key):
            if fixed[key]:
                return meta[key]
            return np.asarray(per_frame[key])[indices]

        if distort_fixed:
            dp = np.array([float(meta.get(k, 0.0)) for k in _DISTORTION],
                          np.float32)
            distortion_params = np.broadcast_to(dp, (len(indices), 6)).copy()
        else:
            distortion_params = np.asarray(distort, np.float32)[indices]
        ds = 1.0 / (config.downscale_factor or 1)
        camera_type = (CAMERA_MODEL_TO_TYPE[meta["camera_model"]]
                       if "camera_model" in meta else CameraType.PERSPECTIVE)
        cameras = Cameras.create(
            camera_to_worlds=poses[indices, :3, :4],
            fx=np.asarray(gather("fl_x"), np.float32) * ds,
            fy=np.asarray(gather("fl_y"), np.float32) * ds,
            cx=np.asarray(gather("cx"), np.float32) * ds,
            cy=np.asarray(gather("cy"), np.float32) * ds,
            width=(np.asarray(gather("w")) * ds).astype(np.int32),
            height=(np.asarray(gather("h")) * ds).astype(np.int32),
            distortion_params=distortion_params,
            camera_type=camera_type,
            device="cpu",
        )
        s = config.scene_scale
        return DataparserOutputs(
            image_filenames=[image_filenames[i] for i in indices],
            cameras=cameras,
            scene_box=SceneBox(aabb=torch.tensor([[-s] * 3, [s] * 3],
                                                 dtype=torch.float32)),
            mask_filenames=[mask_filenames[i] for i in indices
                            if mask_filenames] or None,
            dataparser_scale=scale_factor,
            dataparser_transform=transform_matrix,
            metadata={
                "depth_filenames": [depth_filenames[i] for i in indices
                                    if depth_filenames] or None,
                "depth_unit_scale_factor": config.depth_unit_scale_factor,
            },
        )
