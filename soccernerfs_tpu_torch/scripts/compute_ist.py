"""Offline IST/ISG weight caches and previews (counterpart of
scripts/compute_ist.py).

    python -m soccernerfs_tpu_torch.scripts.compute_ist --data <scene-root> \\
        --dataparser broadcaststyle-data [--isg] [--ist-range 1.0] \\
        [--save-maps] [--device cpu]

Computes the importance weights of a split's images on the CUDA device
(``--device`` names another) and writes the cache file the data path
loads, next to the images, under the JAX script's name; ``--save-maps``
also writes turbo-coloured side-by-side previews to
``<images>/../{ist,isg}_maps_offline/``.
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from soccernerfs_tpu_torch.data import importance
from soccernerfs_tpu_torch.data.dataparsers import DATAPARSERS
from soccernerfs_tpu_torch.data.datasets import DynamicDataset, ImportanceSamplingConfig
from soccernerfs_tpu_torch.utils.colormaps import apply_colormap
from soccernerfs_tpu_torch.utils.device import resolve_device


def main(argv=None) -> np.ndarray:
    """Parse ``argv`` (``sys.argv[1:]`` by default), compute and cache the
    weights; returns them ([B, H, W] float16)."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--data", type=Path, required=True)
    p.add_argument("--dataparser", default="broadcaststyle-data", choices=sorted(DATAPARSERS))
    p.add_argument("--split", default="train")
    p.add_argument("--isg", action="store_true")
    p.add_argument("--ist-range", type=float, default=1.0)
    p.add_argument("--isg-gamma", type=float, default=5e-2)
    p.add_argument("--save-maps", action="store_true")
    p.add_argument("--device", default=None, help="default: cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    cfg = DATAPARSERS[args.dataparser](data=args.data)
    outputs = cfg.setup().get_dataparser_outputs(args.split)
    ds = DynamicDataset(
        outputs,
        is_config=ImportanceSamplingConfig(
            isg=args.isg, ist_range=args.ist_range, isg_gamma=args.isg_gamma
        ),
        device=device,
    )
    print(f"loading {len(ds)} images...")
    batch = {
        "image_idx": np.arange(len(ds)),
        "image": np.stack([ds.get_image(i) for i in range(len(ds))]),
    }
    if args.isg:
        w = importance.isg_maps(ds, batch, args.isg_gamma, args.split,
                                offline=True, device=device)
    else:
        w = importance.ist_maps(ds, batch, args.ist_range, args.split,
                                offline=True, device=device)
    w = w.cpu().numpy()
    print(f"weights: {w.shape} {w.dtype}, nonzero frac {float((w > 0).mean()):.3f}")

    if args.save_maps:
        from PIL import Image

        kind = "isg" if args.isg else "ist"
        folder = ds.image_filenames[0].absolute().parent.parent / f"{kind}_maps_offline"
        folder.mkdir(exist_ok=True, parents=True)
        for i in range(len(ds)):
            colored = apply_colormap(np.asarray(w[i], np.float32))
            side = np.concatenate([batch["image"][i], colored], axis=1)
            Image.fromarray((side * 255).astype(np.uint8)).save(
                folder / ds.image_filenames[i].name
            )
        print(f"maps written to {folder}")
    return w


if __name__ == "__main__":
    main()
