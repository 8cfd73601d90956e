"""Equirectangular tools and the hloc SfM route of snt-process-data
(counterpart of soccernerfs_tpu/scripts/sfm_tools.py).

Perspective crops of equirectangular panoramas for SfM: numpy bilinear
resampling (the longitude wraps, the latitude clamps), the 8- and 14-view
ring patterns with their crop cascade, and PIL for the files.  ``run_hloc``
needs the optional hloc and pycolmap packages and raises without them,
as COLMAP and ffmpeg are gated on their binaries.
"""
from __future__ import annotations

import importlib.util
import math
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

IMAGE_EXTS = (".jpg", ".jpeg", ".png")


# ---------------------------------------------------------------------------
# equirect -> perspective
# ---------------------------------------------------------------------------

def equirect_to_perspective(
    equi: np.ndarray,
    fov_x_deg: float,
    yaw_deg: float,
    pitch_deg: float,
    out_hw: Tuple[int, int],
) -> np.ndarray:
    """Render a pinhole view from an equirectangular panorama.

    Args:
        equi: [He, We, C] uint8/float equirectangular image (longitude
            spans [-180, 180) left-to-right, latitude [-90, 90]
            top-to-bottom).
        fov_x_deg: horizontal field of view of the virtual camera.
        yaw_deg: rotation around the vertical axis (positive = look right).
        pitch_deg: elevation (positive = look up).
        out_hw: (H, W) of the perspective image.
    Returns:
        [H, W, C] image, dtype preserved (bilinear resample).
    """
    he, we = equi.shape[:2]
    h, w = out_hw
    f = (w / 2.0) / math.tan(math.radians(fov_x_deg) / 2.0)
    xs = (np.arange(w, dtype=np.float64) + 0.5) - w / 2.0
    ys = (np.arange(h, dtype=np.float64) + 0.5) - h / 2.0
    gx, gy = np.meshgrid(xs, ys)
    # camera frame: +z forward, +x right, +y down
    d = np.stack([gx, gy, np.full_like(gx, f)], axis=-1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)

    pitch = math.radians(pitch_deg)
    yaw = math.radians(yaw_deg)
    # pitch: rotate view up by `pitch` (about x), then yaw about vertical y
    cp, sp = math.cos(pitch), math.sin(pitch)
    rx = np.array([[1, 0, 0], [0, cp, sp], [0, -sp, cp]])
    cy_, sy_ = math.cos(yaw), math.sin(yaw)
    ry = np.array([[cy_, 0, sy_], [0, 1, 0], [-sy_, 0, cy_]])
    d = d @ (ry @ rx).T

    lon = np.arctan2(d[..., 0], d[..., 2])          # [-pi, pi)
    lat = np.arcsin(np.clip(d[..., 1], -1.0, 1.0))  # [-pi/2, pi/2], +down
    u = (lon / (2 * math.pi) + 0.5) * we - 0.5
    v = (lat / math.pi + 0.5) * he - 0.5

    u0 = np.floor(u)
    v0 = np.floor(v)
    tu = (u - u0)[..., None]
    tv = (v - v0)[..., None]
    u0 = u0.astype(np.int64) % we                    # longitude wraps
    u1 = (u0 + 1) % we
    v0 = np.clip(v0.astype(np.int64), 0, he - 1)     # latitude clamps
    v1 = np.clip(v0 + 1, 0, he - 1)

    img = equi.astype(np.float32)
    top = img[v0, u0] * (1 - tu) + img[v0, u1] * tu
    bot = img[v1, u0] * (1 - tu) + img[v1, u1] * tu
    out = top * (1 - tv) + bot * tv
    if np.issubdtype(equi.dtype, np.integer):
        return np.clip(np.round(out), 0, 255).astype(equi.dtype)
    return out.astype(equi.dtype)


def _crop_bounds_vertical(
    bounds: List[float], fov: float,
    crop_factor: Sequence[float],
) -> List[Optional[float]]:
    """Adjust the pitch rings for top/bottom cropping.

    Mirrors the reference's cascade (ref: equirect_utils.py:39-110): a
    cropped-out ring becomes None; a partially cropped ring is pulled to
    the new limit and inner rings shift by geometrically decaying halves.
    """
    arr: List[Optional[float]] = list(bounds)

    if crop_factor[1] > 0:  # bottom crop removes the TOP-most rings
        chopped = 180.0 * crop_factor[1]
        new_start = 90.0 - chopped - fov / 2.0
        for i in reversed(range(len(arr))):
            el = arr[i]
            if el is None:
                continue
            if el > new_start + fov / 2.0:
                arr[i] = None
            elif el > new_start:
                diff = el - new_start
                arr[i] = new_start
                for j in range(i - 1, -1, -1):
                    if arr[j] is not None:
                        arr[j] -= diff / (2 ** (i - j))
                break
    if crop_factor[0] > 0:  # top crop removes the BOTTOM-most rings
        chopped = 180.0 * crop_factor[0]
        new_start = -90.0 + chopped + fov / 2.0
        for i in range(len(arr)):
            el = arr[i]
            if el is None:
                continue
            if el < new_start - fov / 2.0:
                arr[i] = None
            elif el < new_start:
                diff = new_start - el
                arr[i] = new_start
                for j in range(i + 1, len(arr)):
                    if arr[j] is not None:
                        arr[j] += diff / (2 ** (j - i))
                break
    return arr


def equirect_view_directions(
    samples_per_im: int,
    crop_factor: Sequence[float] = (0.0, 0.0, 0.0, 0.0),
) -> Tuple[float, List[Tuple[float, float]]]:
    """(fov, [(yaw, pitch), ...]) patterns for 8- or 14-view sampling.

    Matches the reference's ring layout (ref: equirect_utils.py:139-170):
    8 views = fov 120, equator every 90 deg + one up/down pair;
    14 views = fov 110, equator every 60 deg + up/down rings every 90 deg.
    crop_factor is (top, bottom, left, right) in [0, 1].
    """
    for c in crop_factor:
        if c < 0.0 or c > 1.0:
            raise ValueError("crop factors must be in [0, 1]")
    left, right = -180.0, 180.0
    if crop_factor[3] > 0:
        left = -180.0 + 360.0 * crop_factor[3]
    if crop_factor[2] > 0:
        right = 180.0 - 360.0 * crop_factor[2]

    if samples_per_im == 8:
        fov, steps = 120.0, (180.0, 90.0, 180.0)
    elif samples_per_im == 14:
        fov, steps = 110.0, (90.0, 60.0, 90.0)
    else:
        raise ValueError("samples_per_im must be 8 or 14")
    rings = _crop_bounds_vertical([-45.0, 0.0, 45.0], fov, crop_factor)

    pairs: List[Tuple[float, float]] = []
    order = (1, 2, 0)  # equator first, then up ring, then down ring
    for idx in order:
        pitch = rings[idx]
        if pitch is None:
            continue
        for yaw in np.arange(left, right, steps[idx]):
            pairs.append((float(yaw), float(pitch)))
    return fov, pairs


def compute_resolution_from_equirect(
    image_dir: Path, num_images: int
) -> Tuple[int, int]:
    """Square crop resolution s.t. num_images * res^2 ~= equirect pixels
    (ref: equirect_utils.py:206-218)."""
    from PIL import Image

    for p in sorted(Path(image_dir).iterdir()):
        if p.suffix.lower() in IMAGE_EXTS:
            with Image.open(p) as im:
                w, h = im.size
            res = int(math.sqrt(h * w / num_images))
            return (res, res)
    raise ValueError(f"no images found in {image_dir}")


def generate_planar_projections_from_equirectangular(
    image_dir: Path,
    planar_image_size: Tuple[int, int],
    samples_per_im: int,
    crop_factor: Sequence[float] = (0.0, 0.0, 0.0, 0.0),
) -> Path:
    """Write perspective crops of every equirect image to
    ``image_dir/planar_projections`` (ref: equirect_utils.py:113-203).

    Args:
        planar_image_size: (width, height) of each crop.
        samples_per_im: 8 or 14 views per panorama.
        crop_factor: (top, bottom, left, right) fractions to drop.
    Returns:
        the output directory.
    """
    from PIL import Image

    image_dir = Path(image_dir)
    fov, pairs = equirect_view_directions(samples_per_im, crop_factor)
    out_dir = image_dir / "planar_projections"
    out_dir.mkdir(exist_ok=True)
    w, h = planar_image_size
    n = 0
    for p in sorted(image_dir.iterdir()):
        if p.suffix.lower() not in IMAGE_EXTS:
            continue
        equi = np.asarray(Image.open(p).convert("RGB"))
        for count, (yaw, pitch) in enumerate(pairs):
            # reference pitch is positive-up; sampling frame is +y down
            pers = equirect_to_perspective(equi, fov, yaw, -pitch, (h, w))
            Image.fromarray(pers).save(out_dir / f"{p.stem}_{count}.jpg")
            n += 1
    print(f"wrote {n} planar projections to {out_dir}")
    return out_dir


# ---------------------------------------------------------------------------
# hloc SfM fallback
# ---------------------------------------------------------------------------

def have_hloc() -> bool:
    return (
        importlib.util.find_spec("hloc") is not None
        and importlib.util.find_spec("pycolmap") is not None
    )


def run_hloc(
    image_dir: Path,
    colmap_dir: Path,
    camera_model: str = "OPENCV",
    matching_method: str = "vocab_tree",
    feature_type: str = "superpoint_aachen",
    matcher_type: str = "superglue",
    num_matched: int = 50,
    verbose: bool = False,
) -> Path:
    """Learned-feature SfM via the hloc toolbox (optional dependency).

    Mirrors the reference pipeline (ref: hloc_utils.py:55-139): netvlad
    retrieval (or exhaustive pairs), feature extraction, matching, then a
    pycolmap reconstruction into ``colmap_dir/sparse/0``.

    Raises:
        RuntimeError: when hloc/pycolmap are not installed.
    Returns:
        the sparse model directory.
    """
    if not have_hloc():
        raise RuntimeError(
            "hloc/pycolmap are not installed — install "
            "github.com/cvg/Hierarchical-Localization to use "
            "--sfm-tool hloc, or use the default COLMAP path."
        )
    import pycolmap
    from hloc import (  # noqa: PLC0415
        extract_features,
        match_features,
        pairs_from_exhaustive,
        pairs_from_retrieval,
        reconstruction,
    )

    image_dir = Path(image_dir)
    outputs = Path(colmap_dir)
    outputs.mkdir(parents=True, exist_ok=True)
    sfm_pairs = outputs / "pairs-netvlad.txt"
    sfm_dir = outputs / "sparse" / "0"
    features = outputs / "features.h5"
    matches = outputs / "matches.h5"

    references = [
        p.relative_to(image_dir).as_posix()
        for p in image_dir.iterdir()
        if p.suffix.lower() in IMAGE_EXTS
    ]
    feature_conf = extract_features.confs[feature_type]
    matcher_conf = match_features.confs[matcher_type]
    extract_features.main(
        feature_conf, image_dir, image_list=references, feature_path=features
    )
    if matching_method == "exhaustive":
        pairs_from_exhaustive.main(sfm_pairs, image_list=references)
    else:
        retrieval_path = extract_features.main(
            extract_features.confs["netvlad"], image_dir, outputs
        )
        pairs_from_retrieval.main(
            retrieval_path, sfm_pairs,
            num_matched=min(num_matched, len(references)),
        )
    match_features.main(
        matcher_conf, sfm_pairs, features=features, matches=matches
    )
    reconstruction.main(
        sfm_dir, image_dir, sfm_pairs, features, matches,
        camera_mode=pycolmap.CameraMode.SINGLE,
        image_options=pycolmap.ImageReaderOptions(camera_model=camera_model),
        verbose=verbose,
    )
    return sfm_dir
