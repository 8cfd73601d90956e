"""Soccer-scene dataparsers: stadium / closeup / broadcaststyle /
stadiumwide / dynamic (counterpart of
soccernerfs_tpu/data/dataparsers/soccer.py; the same engine, tables and
splits).

One shared engine (``SoccerSceneParser``) drives every scene; each scene
contributes a ``SceneSpec``: its camera-name -> id mapping, its
train/eval split rule, and its config defaults.

The pipeline: transforms.json -> per-frame (cam_id, time_step) from the
filename -> static filtering -> existence check against the ``{k}x/``
downscale dir -> fps_downsample time filter (np.linspace over the step
range) -> pose auto-orient/center/scale -> split-camera index selection ->
AABB scene box (optionally floor-capped) -> Cameras (on the CPU) with
normalized ``times`` and per-physical-camera ``ids`` -> intrinsics
rescaled by the downscale factor.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from pathlib import Path, PurePath
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from soccernerfs_tpu_torch.core.cameras import CAMERA_MODEL_TO_TYPE, Cameras, CameraType
from soccernerfs_tpu_torch.core.pose_utils import auto_orient_and_center_poses
from soccernerfs_tpu_torch.core.scene_box import SceneBox
from soccernerfs_tpu_torch.data.dataparsers.base import (
    DataParser,
    DataParserConfig,
    DataparserOutputs,
    load_from_json,
)

# ---------------------------------------------------------------------------
# Scene camera tables
# ---------------------------------------------------------------------------

# Broadcast-style (Scene 2): 20 broadcast cameras + 8 high "global" cameras
# (ref: broadcaststyle_dataparser.py:44-73).
BROADCASTSTYLE_CAM_IDS = {f"Camera_{i}": i - 1 for i in range(1, 21)}
BROADCASTSTYLE_CAM_IDS.update({f"global_{i}": 19 + i for i in range(1, 9)})

# Close-up (Scene 1): broadcast-style rig + 30 Zoom cameras
# (ref: closeup_dataparser.py:46-107).
CLOSEUP_CAM_IDS = {
    "HBG": 0, "Left": 1, "Right": 2, "Main": 3,
    "HBG_opp": 4, "Left_opp": 5, "Right_opp": 6, "Main_opp": 7,
}
CLOSEUP_CAM_IDS.update({f"Inter_{i}": 7 + i for i in range(1, 13)})
CLOSEUP_CAM_IDS.update({f"global_{i}": 19 + i for i in range(1, 9)})
CLOSEUP_CAM_IDS.update({f"Zoom{i}": 27 + i for i in range(1, 31)})

# Named train/eval split setups (ref: broadcaststyle_dataparser.py:78-192,
# closeup_dataparser.py:110-149).  The name sets describe the *physical*
# broadcast rig; in the reference the broadcast-style CAM_IDS table only
# contains Camera_*/global_* so setups other than "all" raise KeyError
# there — a latent defect we surface with a clear error instead.
_REAL_TRAIN = ["HBG", "Left", "Right", "Main"]
_OPP = ["HBG_opp", "Left_opp", "Right_opp", "Main_opp"]
SOCCER_SETUPS = {
    "real": {"train": list(_REAL_TRAIN), "eval": ["Inter_1"]},
    "real+opp": {
        "train": _REAL_TRAIN + _OPP
        + ["Inter_4", "Inter_6", "Inter_7", "Inter_9", "Inter_11"],
        "eval": ["Inter_1", "Inter_2", "Inter_3", "Inter_5", "Inter_8"],
    },
    "low": {
        "train": _REAL_TRAIN + _OPP
        + [f"Inter_{i}" for i in (1, 2, 3, 4, 5, 6, 7, 9, 10, 11, 12)],
        "eval": ["Inter_8"],
    },
    "global": {
        "train": [f"global_{i}" for i in range(1, 9)],
        "eval": ["Inter_2", "Inter_5", "Inter_8", "Inter_11"],
    },
    "all": {
        "train": [f"Camera_{i}" for i in range(1, 20)],
        "eval": ["Camera_20"],
    },
    "zoom": {
        "train": [f"Zoom{i}" for i in range(1, 30)],
        "eval": ["Zoom30"],
    },
}

# Stadium-wide (Scene 3): 11 bleacher clusters x 10 cameras + 6 close eval
# cameras (ref: stadiumwide_dataparser.py:48-80; stadium_dataparser.py:59-72).
CAMERA_LOCATIONS = [
    "Ext Left-Left",
    "Left-Middle",
    "Middle-Right",
    "Right-Ext Right",
    "Ext Right-High Behind Right",
    "High Behind Right-Ext Op Right",
    "Ext Op Right-Op Right",
    "Op Right-Op Middle",
    "Op Middle-Op Left",
    "Op Left-Ext Op Left",
    "Ext Op Left-High Behind Left",
]
CLOSE_CAMERAS = {
    "Center": 110,
    "GoalLeft": 111,
    "GoalRight": 112,
    "PlayerLeft": 113,
    "PlayerRight": 114,
    "Shooter": 115,
}


def _named_cam_id(table: dict, fname: str) -> Tuple[int, int]:
    """``Name_step.ext`` -> (cam_id, time_step)
    (ref: broadcaststyle_dataparser.py:242-259)."""
    stem, step = fname.rsplit("_", 1)
    return int(table[stem]), int(step.split(".")[0])


def _cluster_cam_id(fname: str) -> Tuple[int, int]:
    """``Loc-localid_step.ext`` or ``CloseName_step.ext`` -> (global_id, step)
    (ref: stadium_dataparser.py:121-145; stadiumwide_dataparser.py:74-79)."""
    name, step = fname.rsplit("_", 1)
    time_step = int(step.split(".")[0])
    if "-" in name:
        loc, local_id = name.rsplit("-", 1)
        return CAMERA_LOCATIONS.index(loc) * 10 + int(local_id), time_step
    return CLOSE_CAMERAS[name], time_step


def _numeric_cam_id(fname: str) -> Tuple[int, int]:
    """``camid_step.ext`` with 1-based steps -> (cam_id, step-1)
    (ref: dynamic_dataparser.py:82-97)."""
    stem = fname.split(".")[0]
    cam, step = stem.split("_")[0], stem.split("_")[1]
    return int(cam), int(step) - 1


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------

@dataclass
class SoccerSceneParserConfig(DataParserConfig):
    """Options shared by every soccer-scene parser
    (ref: broadcaststyle_dataparser.py:196-232 and siblings)."""

    data: Path = Path("data/scene/")
    scale_factor: float = 1.0
    downscale_factor: Optional[int] = 2
    scene_scale: float = 1.5
    orientation_method: str = "none"  # pca | up | vertical | none
    center_method: str = "none"  # poses | focus | none
    auto_scale_poses: bool = True
    depth_unit_scale_factor: float = 0.01
    depth_maps: str = "none"  # depth-maps | depth-maps_field | none
    depth_mask: str = "mask"  # none | od | od_below | ist | mask | mask_below | field
    cap_box_floor: bool = False
    static: bool = False
    static_allimgs: bool = False
    static_timestep: int = -1
    fps_downsample: float = 1.0


@dataclass
class BroadcaststyleDataParserConfig(SoccerSceneParserConfig):
    """Scene 2 (ref: broadcaststyle_dataparser.py:196-232)."""

    data: Path = Path("data/broadcaststyle/")
    fps_downsample: float = 3.0
    cam_split_setup: str = "all"

    def setup(self):
        return SoccerSceneParser(self, _SCENES["broadcaststyle"])


@dataclass
class CloseupDataParserConfig(SoccerSceneParserConfig):
    """Scene 1 (ref: closeup_dataparser.py:151-196)."""

    data: Path = Path("data/closeup/")
    fps_downsample: float = 3.0
    cam_split_setup: str = "zoom"

    def setup(self):
        return SoccerSceneParser(self, _SCENES["closeup"])


@dataclass
class StadiumwideDataParserConfig(SoccerSceneParserConfig):
    """Scene 3 (ref: stadiumwide_dataparser.py:83-123)."""

    data: Path = Path("data/stadiumwide/")
    scene_scale: float = 1.0
    nb_train_cameras: int = 110
    closeup_training: bool = False

    def setup(self):
        return SoccerSceneParser(self, _SCENES["stadiumwide"])


@dataclass
class StadiumDataParserConfig(SoccerSceneParserConfig):
    """Synthetic stadium / stadium-players scene
    (ref: stadium_dataparser.py:75-118)."""

    data: Path = Path("data/stadium/")
    orientation_method: str = "up"
    center_method: str = "poses"
    depth_unit_scale_factor: float = 1e-3
    train_split_percentage: float = 0.95
    camera_location: str = "Op Right-Op Middle"
    apply_camera_location_filter: bool = False
    """The reference documents a camera-location filter but its
    implementation is commented out (stadium_dataparser.py:196-215);
    enable this flag for the documented behavior."""

    def setup(self):
        return SoccerSceneParser(self, _SCENES["stadium"])


@dataclass
class DynamicDataParserConfig(SoccerSceneParserConfig):
    """Generic dynamic scene, ``camid_step`` filenames
    (ref: dynamic_dataparser.py:46-78)."""

    data: Path = Path("data/dynamic/")
    train_split_percentage: float = 1.0

    def setup(self):
        return SoccerSceneParser(self, _SCENES["dynamic"])


# ---------------------------------------------------------------------------
# Per-scene specs
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SceneSpec:
    """What differs between soccer scenes."""

    name: str
    frame_metadata: Callable[[str], Tuple[int, int]]
    # select_cams(config, split, cam_uids) -> (split_cams, prefilter_cams or None)
    select_cams: Callable
    empty_dir_suffix: Optional[str] = None  # e.g. "broadcaststyle_empty"
    one_based_split_ids: bool = False  # dynamic parser's +1 quirk


def _make_setup_select(cam_table: dict):
    """Named-setup split bound to a scene's camera table
    (ref: broadcaststyle_dataparser.py:302-307)."""

    def select(config, split, cam_uids):
        setup = SOCCER_SETUPS.get(config.cam_split_setup)
        if setup is None:
            raise ValueError(f"unknown cam_split_setup {config.cam_split_setup!r}")
        key = "train" if split == "train" else "eval"
        other = "eval" if key == "train" else "train"

        def names_to_ids(names):
            missing = [n for n in names if n not in cam_table]
            if missing:
                raise ValueError(
                    f"setup {config.cam_split_setup!r} references cameras absent "
                    f"from this scene: {missing} (latent KeyError in the reference)"
                )
            return [cam_table[n] for n in names]

        split_cams = names_to_ids(setup[key])
        prefilter = split_cams + names_to_ids(setup[other])
        return split_cams, prefilter

    return select


def _stadiumwide_select(config, split, cam_uids):
    """Eval = the 6 close cameras; train = nb_train_cameras equally spaced
    bleacher cams (+close cams when closeup_training)
    (ref: stadiumwide_dataparser.py:270-280)."""
    if split == "train":
        cams = np.linspace(0, 109, config.nb_train_cameras).astype(np.int64).tolist()
        if config.closeup_training:
            cams = cams + list(range(110, 116))
        return cams, None
    return list(range(110, 116)), None


def _percentage_select(config, split, cam_uids):
    """Equally-spaced percentage split over unique camera ids
    (ref: stadium_dataparser.py:290-310; dynamic_dataparser.py:228-244
    uses 1-based ids)."""
    if cam_uids is None:
        # uids not collected yet: no prefilter, engine calls again later
        return [], None
    num_cams = len(np.unique(cam_uids))
    num_train = math.ceil(num_cams * config.train_split_percentage)
    offset = 1 if getattr(config, "_one_based", False) else 0
    i_all = np.arange(num_cams) + offset
    i_train = np.linspace(0, num_cams - 1, num_train, dtype=int) + offset
    i_eval = np.setdiff1d(i_all, i_train)
    if split == "train":
        return i_train.tolist(), None
    if split in ("val", "test", "eval"):
        return i_eval.tolist(), None
    raise ValueError(f"unknown split {split}")


_SCENES = {
    "broadcaststyle": SceneSpec(
        name="broadcaststyle",
        frame_metadata=lambda f: _named_cam_id(BROADCASTSTYLE_CAM_IDS, f),
        select_cams=_make_setup_select(BROADCASTSTYLE_CAM_IDS),
        empty_dir_suffix="broadcaststyle_empty",
    ),
    "closeup": SceneSpec(
        name="closeup",
        frame_metadata=lambda f: _named_cam_id(CLOSEUP_CAM_IDS, f),
        select_cams=_make_setup_select(CLOSEUP_CAM_IDS),
        empty_dir_suffix="closeup_empty",
    ),
    "stadiumwide": SceneSpec(
        name="stadiumwide",
        frame_metadata=_cluster_cam_id,
        select_cams=_stadiumwide_select,
    ),
    "stadium": SceneSpec(
        name="stadium",
        frame_metadata=_cluster_cam_id,
        select_cams=_percentage_select,
    ),
    "dynamic": SceneSpec(
        name="dynamic",
        frame_metadata=_numeric_cam_id,
        select_cams=_percentage_select,
        one_based_split_ids=True,
    ),
}


# ---------------------------------------------------------------------------
# The shared engine
# ---------------------------------------------------------------------------

class SoccerSceneParser(DataParser):
    """Shared parser engine for all soccer scenes (see module docstring)."""

    def __init__(self, config: SoccerSceneParserConfig, spec: SceneSpec):
        super().__init__(config)
        self.spec = spec

    def _get_fname(self, filepath: PurePath, data_dir: Path) -> Path:
        """Rewrite a transforms.json path into its ``{k}x/`` downscaled
        sibling (ref: broadcaststyle_dataparser.py:531-548)."""
        old_path = data_dir / filepath
        return old_path.parent / f"{self.config.downscale_factor}x" / old_path.name

    def _generate_dataparser_outputs(self, split="train") -> DataparserOutputs:
        config = self.config
        spec = self.spec
        data = Path(config.data)

        # static empty-field mode redirects to the sibling *_empty dataset
        # (ref: broadcaststyle_dataparser.py:264-265)
        if config.static and config.static_timestep == -1 and spec.empty_dir_suffix:
            data = data.parent / spec.empty_dir_suffix

        if data.suffix == ".json":
            meta = load_from_json(data)
            data_dir = data.parent
        else:
            meta = load_from_json(data / "transforms.json")
            data_dir = data

        fixed = {k: k in meta for k in ("fl_x", "fl_y", "cx", "cy", "h", "w")}
        distort_fixed = any(k in meta for k in ("k1", "k2", "k3", "p1", "p2"))

        image_filenames: List[Path] = []
        mask_filenames: List[Path] = []
        depth_filenames: List[Path] = []
        poses = []
        fx, fy, cx, cy, height, width, distort = [], [], [], [], [], [], []
        times: List[int] = []
        cam_uids: List[int] = []
        num_skipped = 0

        if getattr(config, "train_split_percentage", None) is not None:
            config._one_based = spec.one_based_split_ids  # type: ignore[attr-defined]

        # For named-setup scenes, frames outside train∪eval are dropped
        # before pose orientation so auto-scale ignores them
        # (ref: broadcaststyle_dataparser.py:319-321).
        prefilter = None
        split_cams, prefilter = spec.select_cams(config, split, None)

        for frame in meta["frames"]:
            filepath = PurePath(frame["file_path"])
            fname = self._get_fname(filepath, data_dir)
            if not fname.exists():
                num_skipped += 1
                continue

            cam_id, time_step = spec.frame_metadata(fname.name)

            if prefilter is not None and cam_id not in prefilter:
                continue

            # static single-timestep filtering
            # (ref: broadcaststyle_dataparser.py:323-328)
            if config.static and not config.static_allimgs:
                want = 0 if config.static_timestep == -1 else config.static_timestep
                if time_step != want:
                    continue

            cam_uids.append(cam_id)
            times.append(time_step)

            def per_frame(key, out, cast):
                if not fixed[key]:
                    if key not in frame:
                        raise ValueError(f"{key} not in frame {frame['file_path']}")
                    out.append(cast(frame[key]))

            per_frame("fl_x", fx, float)
            per_frame("fl_y", fy, float)
            per_frame("cx", cx, float)
            per_frame("cy", cy, float)
            per_frame("h", height, int)
            per_frame("w", width, int)
            if not distort_fixed:
                distort.append(
                    [float(frame.get(k, 0.0)) for k in ("k1", "k2", "k3", "k4", "p1", "p2")]
                )

            image_filenames.append(fname)
            poses.append(np.array(frame["transform_matrix"], dtype=np.float64))

            if "mask_path" in frame:
                mask_filenames.append(self._get_fname(PurePath(frame["mask_path"]), data_dir))

            # depth path rewriting: select the masked depth variant
            # (ref: broadcaststyle_dataparser.py:375-384)
            if "depth_file_path" in frame and config.depth_maps != "none":
                dpath = frame["depth_file_path"]
                if config.depth_mask != "none":
                    dpath = dpath.replace("depth-maps", "depth-maps-" + config.depth_mask)
                if config.depth_maps != "depth-maps":
                    dpath = dpath.replace("depth-maps", config.depth_maps)
                depth_filenames.append(self._get_fname(PurePath(dpath), data_dir))

        if not image_filenames:
            raise FileNotFoundError(
                f"No image files found for split {split}; checked under "
                f"{data_dir}/.../{config.downscale_factor}x/ (skipped {num_skipped})")
        for name, files in (("mask", mask_filenames), ("depth", depth_filenames)):
            if files and len(files) != len(image_filenames):
                raise ValueError(f"{len(files)} {name} files for "
                                 f"{len(image_filenames)} images")

        # fps downsampling over the time-step range
        # (ref: broadcaststyle_dataparser.py:407-412)
        max_step = max(times)
        times_filter = np.arange(max_step + 1)
        if config.fps_downsample > 1:
            base_duration = max_step + 1
            new_duration = int(base_duration / config.fps_downsample)
            times_filter = np.linspace(0, base_duration - 1, new_duration).astype(np.int32)
        times_filter_set = set(int(t) for t in times_filter)

        # percentage-split scenes need the collected uids
        if prefilter is None:
            split_cams, _ = spec.select_cams(config, split, cam_uids)
        split_cam_set = set(int(c) for c in split_cams)

        if (
            spec.name == "stadium"
            and getattr(config, "apply_camera_location_filter", False)
        ):
            loc_prefix = config.camera_location + "-"
            loc_ok = [f.name.startswith(loc_prefix) for f in image_filenames]
        else:
            loc_ok = [True] * len(image_filenames)

        indices = [
            i
            for i in range(len(image_filenames))
            if cam_uids[i] in split_cam_set and times[i] in times_filter_set and loc_ok[i]
        ]
        if not indices:
            raise ValueError(f"split {split} selected no frames")

        orientation_method = meta.get("orientation_override", config.orientation_method)

        poses = np.stack(poses).astype(np.float32)
        poses, transform_matrix = auto_orient_and_center_poses(
            poses, method=orientation_method, center_method=config.center_method
        )

        scale_factor = 1.0
        if config.auto_scale_poses:
            scale_factor /= float(np.max(np.abs(poses[:, :3, 3])))
        scale_factor *= config.scale_factor
        poses[:, :3, 3] *= scale_factor

        image_filenames = [image_filenames[i] for i in indices]
        mask_filenames = [mask_filenames[i] for i in indices] if mask_filenames else []
        depth_filenames = [depth_filenames[i] for i in indices] if depth_filenames else []
        poses = poses[indices]

        # AABB scene box, optionally floor-capped at -0.1
        # (ref: broadcaststyle_dataparser.py:449-462)
        s = config.scene_scale
        lo = [-s, -s, -0.1] if config.cap_box_floor else [-s, -s, -s]
        scene_box = SceneBox(aabb=torch.tensor([lo, [s, s, s]],
                                             dtype=torch.float32))

        camera_type = (
            CAMERA_MODEL_TO_TYPE[meta["camera_model"]]
            if "camera_model" in meta
            else CameraType.PERSPECTIVE
        )

        def gather(fixed_key, values, cast):
            if fixed[fixed_key]:
                return cast(meta[fixed_key])
            return np.asarray(values)[indices]

        fx_v = gather("fl_x", fx, float)
        fy_v = gather("fl_y", fy, float)
        cx_v = gather("cx", cx, float)
        cy_v = gather("cy", cy, float)
        h_v = gather("h", height, int)
        w_v = gather("w", width, int)

        # normalized times use the pre-filter max step
        # (ref: broadcaststyle_dataparser.py:476-479)
        times_arr = np.asarray(times, dtype=np.float32)[indices]
        if max_step != 0:
            times_arr = times_arr / max_step
        ids_arr = np.asarray(cam_uids, dtype=np.int32)[indices]

        if distort_fixed:
            distortion_params = np.array(
                [float(meta.get(k, 0.0)) for k in ("k1", "k2", "k3", "k4", "p1", "p2")],
                dtype=np.float32,
            )
            distortion_params = np.broadcast_to(
                distortion_params, (len(indices), 6)
            ).copy()
        else:
            distortion_params = np.asarray(distort, dtype=np.float32)[indices]

        # intrinsics rescaled for the downscale factor
        # (ref: Cameras.rescale_output_resolution, cameras.py:787-824)
        ds = 1.0 / config.downscale_factor
        cameras = Cameras.create(
            camera_to_worlds=poses[:, :3, :4],
            fx=np.asarray(fx_v, np.float32) * ds,
            fy=np.asarray(fy_v, np.float32) * ds,
            cx=np.asarray(cx_v, np.float32) * ds,
            cy=np.asarray(cy_v, np.float32) * ds,
            width=(np.asarray(w_v) * ds).astype(np.int32),
            height=(np.asarray(h_v) * ds).astype(np.int32),
            distortion_params=distortion_params,
            camera_type=int(camera_type),
            times=times_arr,
            ids=ids_arr,
            device="cpu",
        )

        return DataparserOutputs(
            image_filenames=image_filenames,
            cameras=cameras,
            scene_box=scene_box,
            mask_filenames=mask_filenames or None,
            dataparser_scale=scale_factor,
            dataparser_transform=transform_matrix,
            metadata={
                "depth_filenames": depth_filenames or None,
                "depth_unit_scale_factor": config.depth_unit_scale_factor,
                "static": config.static,
            },
        )
