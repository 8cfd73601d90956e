"""Mask depth maps around detected players and the ball (counterpart of
scripts/mask_depth_maps.py).

Writes the ``depth-maps-{od,od_below,...}`` variants that the soccer
dataparsers select with ``--depth-mask``: a depth map's pixels inside a
detection's box (``od``), or from its top to the image's bottom
(``od_below``), become 0, which the depth losses leave unsupervised.
Detections come from DynMetric's backends (utils/dynmetric.py): a
sidecar boxes JSON named by ``SNT_DYNMETRIC_BOXES``, else RetinaNet on the
CUDA device (``--device`` names another) from weights already in torch
hub's cache.  Without either, a depth map is copied through unchanged.

    python -m soccernerfs_tpu_torch.scripts.mask_depth_maps \\
        --images data/scene/images/2x --depths data/scene/depth-maps/2x \\
        --out data/scene/depth-maps-od/2x [--mode od|od_below]
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch
from PIL import Image

from soccernerfs_tpu_torch.utils.device import resolve_device
from soccernerfs_tpu_torch.utils.dynmetric import _detect_sidecar, _detect_torchvision


def main(argv=None) -> Path:
    """Parse ``argv`` (``sys.argv[1:]`` by default) and write the masked
    depth maps; returns the output directory."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--images", type=Path, required=True)
    p.add_argument("--depths", type=Path, required=True)
    p.add_argument("--out", type=Path, required=True)
    p.add_argument("--mode", default="od", choices=["od", "od_below"])
    p.add_argument("--device", default=None, help="default: cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    args.out.mkdir(parents=True, exist_ok=True)
    for img_path in sorted(args.images.iterdir()):
        depth_path = args.depths / img_path.name
        if not depth_path.exists():
            continue
        depth = np.asarray(Image.open(depth_path)).astype(np.int32)
        det = _detect_sidecar(img_path.name)
        if det is None:
            image = np.asarray(Image.open(img_path)).astype(np.float32) / 255.0
            det = _detect_torchvision(torch.from_numpy(
                np.ascontiguousarray(image[..., :3])).to(device))
        if det is not None:
            boxes, _ = det
            mask = np.zeros(depth.shape[:2], bool)
            for x1, y1, x2, y2 in boxes:
                y2b = depth.shape[0] if args.mode == "od_below" else int(y2)
                mask[int(y1):y2b, int(x1):int(x2)] = True
            depth = np.where(mask, 0, depth)  # zero = unsupervised
        Image.fromarray(depth, mode="I").save(args.out / img_path.name)
    print(f"wrote masked depth maps to {args.out}")
    return args.out


if __name__ == "__main__":
    main()
