"""snt-render: render a trained run along a camera path (counterpart of
soccernerfs_tpu/scripts/render.py).

    python -m soccernerfs_tpu_torch.scripts.render \
        --load-config <run>/config.yml \
        --traj spiral|interpolate|filename \
        [--camera-path-filename camera_path.json] \
        --output-path renders/output.mp4 \
        [--rendered-output-names rgb depth accumulation] \
        [--output-format video|images]

A video is written with imageio where it is installed; otherwise, as with
``--output-format images``, PNG frames go to a directory named after the
output path without its suffix.  The script prints which it wrote.

Runs on the ranks that the run's ``machine`` config names, as
``snt-train`` does: every rank builds the same cameras and renders every
frame, each chunk's rays split over the ranks; rank 0 alone colour-maps,
prints and writes.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from soccernerfs_tpu_torch.configs.base import load_config
from soccernerfs_tpu_torch.core.camera_paths import (
    get_interpolated_camera_path,
    get_path_from_json,
    get_spiral_path,
)
from soccernerfs_tpu_torch.parallel import mesh
from soccernerfs_tpu_torch.scripts.train import launch
from soccernerfs_tpu_torch.utils.colormaps import apply_colormap, apply_depth_colormap
from soccernerfs_tpu_torch.utils.eval_utils import eval_setup


def compose_frame(outputs, output_names) -> np.ndarray:
    """One written frame: the named outputs side by side (depth
    colour-mapped and blended by accumulation, other single-channel
    outputs colour-mapped), as uint8."""
    parts = []
    for name in output_names:
        img = outputs[name]
        if name == "depth":
            img = apply_depth_colormap(img, outputs.get("accumulation"))
        elif img.ndim == 2:
            img = apply_colormap(img)
        parts.append(np.asarray(img))
    frame = np.concatenate(parts, axis=1)
    return (np.clip(frame, 0, 1) * 255).astype(np.uint8)


def render_trajectory(
    trainer,
    cameras,
    output_names,
    output_path: Path,
    output_format: str = "video",
    fps: int = 24,
) -> Path | None:
    """Render every camera of ``cameras`` and write the uint8 frames
    (``compose_frame``); returns the video file or the frames' directory.
    Over a world every rank renders every frame; rank 0 alone composes,
    prints and writes, and the other ranks return None."""
    main = mesh.is_main_process()
    frames = []
    for i in range(cameras.num_cameras):
        outputs = trainer.render_camera(cameras, i)
        if main:
            frames.append(compose_frame(outputs, output_names))
            print(f"rendered frame {i + 1}/{cameras.num_cameras}", flush=True)
    if not main:
        return None

    output_path.parent.mkdir(parents=True, exist_ok=True)
    if output_format == "video":
        try:
            import imageio

            imageio.mimwrite(str(output_path), frames, fps=fps)
            print(f"wrote video {output_path}")
            return output_path
        except Exception as e:
            print(f"video writing failed ({e}); falling back to images")
    stem = output_path.with_suffix("")
    stem.mkdir(parents=True, exist_ok=True)
    from PIL import Image

    for i, f in enumerate(frames):
        Image.fromarray(f).save(stem / f"{i:05d}.png")
    print(f"wrote {len(frames)} frames to {stem}/")
    return stem


def trajectory(trainer, args: argparse.Namespace):
    """(cameras, fps) of ``--traj``: the same on every rank (the spiral and
    the interpolation from the eval cameras, or the JSON file)."""
    if args.traj == "filename":
        camera_path = json.loads(Path(args.camera_path_filename).read_text())
        return (get_path_from_json(camera_path, device=trainer.device),
                camera_path.get("fps", args.fps))
    if args.traj == "interpolate":
        return (get_interpolated_camera_path(trainer.eval_cameras,
                                             args.interpolation_steps), args.fps)
    return (get_spiral_path(trainer.eval_cameras, steps=args.interpolation_steps),
            args.fps)


def render_rank(device, args: argparse.Namespace) -> Path | None:
    """Set up the run and render its trajectory on this rank; rank 0
    returns what it wrote, the others None."""
    _, trainer, _ = eval_setup(args.load_config, test_mode="inference",
                               device=device)
    cameras, fps = trajectory(trainer, args)
    return render_trajectory(trainer, cameras, args.rendered_output_names,
                             args.output_path, args.output_format, fps)


def main(argv=None, device=None) -> Path:
    """Render the run of ``--load-config`` on the ranks that its
    ``machine`` config names; returns what ``render_trajectory`` wrote
    (local rank 0's).  ``device``: default CUDA; raises when CUDA is
    absent and the caller did not ask for another device."""
    parser = argparse.ArgumentParser("snt-render")
    parser.add_argument("--load-config", type=Path, required=True)
    parser.add_argument(
        "--traj", choices=["spiral", "interpolate", "filename"], default="spiral"
    )
    parser.add_argument("--camera-path-filename", type=Path, default=None)
    parser.add_argument("--output-path", type=Path, default=Path("renders/output.mp4"))
    parser.add_argument("--rendered-output-names", nargs="+", default=["rgb"])
    parser.add_argument("--output-format", choices=["video", "images"], default="video")
    parser.add_argument("--interpolation-steps", type=int, default=30)
    parser.add_argument("--fps", type=int, default=24)
    args = parser.parse_args(argv)
    if args.traj == "filename" and args.camera_path_filename is None:
        parser.error("--traj filename needs --camera-path-filename")
    machine = load_config(args.load_config).machine
    return launch(render_rank, device, machine, (args,))


if __name__ == "__main__":
    main()
