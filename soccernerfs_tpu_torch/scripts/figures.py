"""snt-figures: paper-figure tools, headless (counterpart of
soccernerfs_tpu/scripts/figures.py, with its subcommands and arguments).

  python -m soccernerfs_tpu_torch.scripts.figures crop \
      --gt gt.png --preds p1.png p2.png --rect X Y W H -o out/
  python -m soccernerfs_tpu_torch.scripts.figures split \
      --images strip1.png --panels 3 -o out/
  python -m soccernerfs_tpu_torch.scripts.figures turbo \
      --images depth1.png depth2.png -o out/
  python -m soccernerfs_tpu_torch.scripts.figures cropvid \
      --videos a.mp4 b.mp4 --rect X Y W H -o out/

crop:    the GT with the rectangle drawn, and the rectangle cut from the
         GT and from every prediction.
split:   {GT|Pred1|...|PredN-1} strips into their N panels.
turbo:   the turbo colour map over grayscale images.
cropvid: every frame of each video cut to the rectangle.
"""
from __future__ import annotations

import argparse
import pathlib
import sys
from typing import List, Optional

import numpy as np


def _imread(path: str) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"))


def _imwrite(path: pathlib.Path, arr: np.ndarray) -> None:
    from PIL import Image

    path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(np.asarray(arr, np.uint8)).save(path)


def cmd_crop(args) -> int:
    from soccernerfs_tpu_torch.utils.figures import crop_panels

    gt = _imread(args.gt)
    preds = [_imread(p) for p in args.preds]
    marked, crops = crop_panels(gt, preds, tuple(args.rect))
    out = pathlib.Path(args.output)
    _imwrite(out / "gt_marked.png", marked)
    names = ["gt"] + [pathlib.Path(p).stem for p in args.preds]
    for name, crop in zip(names, crops):
        _imwrite(out / f"crop_{name}.png", crop)
    print(f"wrote {1 + len(crops)} files to {out}")
    return 0


def cmd_split(args) -> int:
    from soccernerfs_tpu_torch.utils.figures import split_strip

    out = pathlib.Path(args.output)
    for path in args.images:
        img = _imread(path)
        panels = split_strip(img, args.panels)
        stem = pathlib.Path(path).stem
        names = ["gt"] + [f"pred{i}" for i in range(1, len(panels))]
        for name, panel in zip(names, panels):
            _imwrite(out / f"{stem}_{name}.png", panel)
    print(f"split {len(args.images)} strips into {args.panels} panels each")
    return 0


def cmd_turbo(args) -> int:
    from PIL import Image

    from soccernerfs_tpu_torch.utils.figures import turbo_colormap

    out = pathlib.Path(args.output)
    for path in args.images:
        g = np.asarray(Image.open(path).convert("L"), np.float32) / 255.0
        _imwrite(out / f"{pathlib.Path(path).stem}_turbo.png",
                 turbo_colormap(g))
    print(f"turbo-mapped {len(args.images)} images to {out}")
    return 0


def cmd_cropvid(args) -> int:
    import imageio.v2 as imageio

    x, y, w, h = args.rect
    out = pathlib.Path(args.output)
    out.mkdir(parents=True, exist_ok=True)
    for path in args.videos:
        reader = imageio.get_reader(path)
        meta = reader.get_meta_data()
        dst = out / f"{pathlib.Path(path).stem}_crop.mp4"
        writer = imageio.get_writer(
            dst, fps=meta.get("fps", 25), macro_block_size=1
        )
        n = 0
        for frame in reader:
            writer.append_data(frame[y:y + h, x:x + w])
            n += 1
        writer.close()
        reader.close()
        print(f"{dst}: {n} frames")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(prog="snt-figures", description=__doc__)
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("crop", help="crop GT+preds to a rectangle")
    p.add_argument("--gt", required=True)
    p.add_argument("--preds", nargs="*", default=[])
    p.add_argument("--rect", nargs=4, type=int, required=True,
                   metavar=("X", "Y", "W", "H"))
    p.add_argument("-o", "--output", default="figures")
    p.set_defaults(fn=cmd_crop)

    p = sub.add_parser("split", help="split GT|Pred strips into panels")
    p.add_argument("--images", nargs="+", required=True)
    p.add_argument("--panels", type=int, required=True)
    p.add_argument("-o", "--output", default="figures")
    p.set_defaults(fn=cmd_split)

    p = sub.add_parser("turbo", help="turbo-colormap grayscale images")
    p.add_argument("--images", nargs="+", required=True)
    p.add_argument("-o", "--output", default="figures")
    p.set_defaults(fn=cmd_turbo)

    p = sub.add_parser("cropvid", help="crop videos to a rectangle")
    p.add_argument("--videos", nargs="+", required=True)
    p.add_argument("--rect", nargs=4, type=int, required=True,
                   metavar=("X", "Y", "W", "H"))
    p.add_argument("-o", "--output", default="figures")
    p.set_defaults(fn=cmd_cropvid)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
