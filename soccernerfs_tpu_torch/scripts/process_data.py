"""snt-process-data: raw captures to a trainable nerfstudio dataset
(counterpart of soccernerfs_tpu/scripts/process_data.py, with its
subcommands, arguments and defaults).

  images          copy (and downscale) images, equirectangular panoramas
                  as perspective crops first, run COLMAP (or hloc) when
                  installed, write transforms.json
  video           extract frames with ffmpeg, then `images`
  colmap-to-json  an existing COLMAP sparse model to transforms.json (no
                  binaries needed)
  polycam, record3d, metashape, realitycapture
                  a capture app's export to transforms.json
  insta360        extract an Insta360 capture's frames with ffmpeg

    python -m soccernerfs_tpu_torch.scripts.process_data colmap-to-json \
        --sparse <colmap>/sparse/0 --output-dir <dataset>

then train on it with `nerfstudio-data --data <dataset>`.  Where COLMAP,
ffmpeg or hloc is missing, the commands that need it exit and say what
to run instead.  Everything here runs on the host.
"""
from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path


def _have(binary: str) -> bool:
    return shutil.which(binary) is not None


def _run_colmap(image_dir: Path, workspace: Path, matcher: str = "vocab_tree"):
    """COLMAP's feature extraction, matching and mapping; the first
    model's directory."""
    db = workspace / "database.db"
    sparse = workspace / "sparse"
    sparse.mkdir(parents=True, exist_ok=True)
    cmds = [
        ["colmap", "feature_extractor", "--database_path", str(db),
         "--image_path", str(image_dir), "--ImageReader.camera_model", "OPENCV",
         "--ImageReader.single_camera", "1"],
        ["colmap", "sequential_matcher" if matcher == "sequential" else "exhaustive_matcher",
         "--database_path", str(db)],
        ["colmap", "mapper", "--database_path", str(db),
         "--image_path", str(image_dir), "--output_path", str(sparse)],
    ]
    for cmd in cmds:
        print("Running:", " ".join(cmd), flush=True)
        subprocess.run(cmd, check=True)
    return sparse / "0"


def cmd_images(args):
    out = args.output_dir
    img_out = out / "images"
    img_out.mkdir(parents=True, exist_ok=True)
    data_dir = args.data

    # equirectangular captures: render perspective crops first and run SfM
    # on those (ref: scripts/process_data.py equirect path +
    # process_data/equirect_utils.py)
    if getattr(args, "camera_type", "perspective") == "equirectangular":
        from soccernerfs_tpu_torch.scripts import sfm_tools

        size = sfm_tools.compute_resolution_from_equirect(
            data_dir, args.images_per_equirect
        )
        data_dir = sfm_tools.generate_planar_projections_from_equirectangular(
            data_dir, size, args.images_per_equirect,
            tuple(args.crop_factor),
        )

    sources = sorted(
        p for p in data_dir.iterdir() if p.suffix.lower() in (".png", ".jpg", ".jpeg")
    )
    for i, src in enumerate(sources):
        shutil.copy(src, img_out / f"frame_{i:05d}{src.suffix.lower()}")
    print(f"copied {len(sources)} images")

    if args.downscale > 1:
        subprocess.run(
            [sys.executable,
             str(Path(__file__).parents[2] / "scripts/downsample_images.py"),
             "--dir", str(img_out), "--factors", str(args.downscale)],
            check=False,
        )

    if args.skip_colmap:
        return
    if getattr(args, "sfm_tool", "colmap") == "hloc":
        # learned-feature fallback when COLMAP's SIFT matching fails
        # (ref: process_data/hloc_utils.py)
        from soccernerfs_tpu_torch.scripts import sfm_tools

        sparse = sfm_tools.run_hloc(
            img_out, out / "colmap",
            matching_method=args.matching_method,
            feature_type=args.feature_type,
            matcher_type=args.matcher_type,
        )
    else:
        if not _have("colmap"):
            raise SystemExit(
                "colmap is not installed; run COLMAP elsewhere and then:\n"
                "  python -m soccernerfs_tpu_torch.scripts.process_data colmap-to-json "
                f"--sparse <model-dir> --output-dir {out}\n"
                "  (or retry with --sfm-tool hloc if hloc is installed)"
            )
        sparse = _run_colmap(img_out, out / "colmap")
    _write_transforms(sparse, out)


def cmd_video(args):
    if not _have("ffmpeg"):
        raise SystemExit(
            "ffmpeg is not installed; extract frames externally "
            "(e.g. ffmpeg -i video.mp4 -qscale:v 2 frames/frame_%05d.png) "
            "then run the `images` subcommand."
        )
    frames_dir = args.output_dir / "raw_frames"
    frames_dir.mkdir(parents=True, exist_ok=True)
    subprocess.run(
        ["ffmpeg", "-i", str(args.data), "-qscale:v", "2",
         "-vf", f"fps={args.fps}", str(frames_dir / "frame_%05d.png")],
        check=True,
    )
    args.data = frames_dir
    cmd_images(args)


def _write_transforms(sparse_dir: Path, out: Path):
    from soccernerfs_tpu_torch.data.colmap_utils import colmap_to_transforms

    meta = colmap_to_transforms(sparse_dir)
    path = out / "transforms.json"
    path.write_text(json.dumps(meta, indent=4))
    print(f"wrote {path} ({len(meta['frames'])} frames)")


def cmd_colmap_to_json(args):
    _write_transforms(args.sparse, args.output_dir)


def main(argv=None):
    parser = argparse.ArgumentParser("snt-process-data")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("images")
    p.add_argument("--data", type=Path, required=True)
    p.add_argument("--output-dir", type=Path, required=True)
    p.add_argument("--downscale", type=int, default=1)
    p.add_argument("--skip-colmap", action="store_true")
    p.add_argument("--camera-type", default="perspective",
                   choices=("perspective", "equirectangular"))
    p.add_argument("--images-per-equirect", type=int, default=8,
                   choices=(8, 14))
    p.add_argument("--crop-factor", type=float, nargs=4,
                   default=(0.0, 0.0, 0.0, 0.0),
                   metavar=("TOP", "BOTTOM", "LEFT", "RIGHT"))
    p.add_argument("--sfm-tool", default="colmap", choices=("colmap", "hloc"))
    p.add_argument("--matching-method", default="vocab_tree",
                   choices=("vocab_tree", "exhaustive", "sequential"))
    p.add_argument("--feature-type", default="superpoint_aachen")
    p.add_argument("--matcher-type", default="superglue")
    p.set_defaults(fn=cmd_images)

    p = sub.add_parser("video")
    p.add_argument("--data", type=Path, required=True)
    p.add_argument("--output-dir", type=Path, required=True)
    p.add_argument("--fps", type=float, default=2.0)
    p.add_argument("--downscale", type=int, default=1)
    p.add_argument("--skip-colmap", action="store_true")
    p.set_defaults(fn=cmd_video)

    p = sub.add_parser("colmap-to-json")
    p.add_argument("--sparse", type=Path, required=True)
    p.add_argument("--output-dir", type=Path, required=True)
    p.set_defaults(fn=cmd_colmap_to_json)

    # capture-app converters (ref: process_data/{polycam,record3d,
    # metashape,realitycapture,insta360}_utils.py)
    from soccernerfs_tpu_torch.scripts import capture_converters as cc

    p = sub.add_parser("polycam")
    p.add_argument("--data", type=Path, required=True)
    p.add_argument("--output-dir", type=Path, required=True)
    p.add_argument("--min-blur-score", type=float, default=25.0)
    p.add_argument("--crop-border-pixels", type=int, default=15)
    p.set_defaults(fn=lambda a: print("\n".join(cc.polycam_to_json(
        a.data, a.output_dir, a.min_blur_score, a.crop_border_pixels))))

    p = sub.add_parser("record3d")
    p.add_argument("--data", type=Path, required=True)
    p.add_argument("--output-dir", type=Path, required=True)
    p.add_argument("--max-dataset-size", type=int, default=300)
    p.set_defaults(fn=lambda a: print(
        f"registered {cc.record3d_to_json(a.data, a.output_dir, a.max_dataset_size)} frames"))

    p = sub.add_parser("metashape")
    p.add_argument("--data", type=Path, required=True, help="image directory")
    p.add_argument("--xml", type=Path, required=True)
    p.add_argument("--output-dir", type=Path, required=True)
    p.set_defaults(fn=lambda a: print("\n".join(
        cc.metashape_to_json(a.xml, a.data, a.output_dir))))

    p = sub.add_parser("realitycapture")
    p.add_argument("--data", type=Path, required=True, help="image directory")
    p.add_argument("--csv", type=Path, required=True)
    p.add_argument("--output-dir", type=Path, required=True)
    p.set_defaults(fn=lambda a: print("\n".join(
        cc.realitycapture_to_json(a.csv, a.data, a.output_dir))))

    p = sub.add_parser("insta360")
    p.add_argument("--data", type=Path, required=True)
    p.add_argument("--output-dir", type=Path, required=True)
    p.add_argument("--num-frames-target", type=int, default=300)
    p.set_defaults(fn=lambda a: cc.convert_insta360(
        a.data, a.output_dir, a.num_frames_target))

    args = parser.parse_args(argv)
    args.output_dir.mkdir(parents=True, exist_ok=True)
    args.fn(args)


if __name__ == "__main__":
    main()
