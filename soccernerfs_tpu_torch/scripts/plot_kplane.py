"""Plot a trained K-Planes snapshot's feature planes (counterpart of
scripts/plot_kplane.py).

Loads a run's latest checkpoint (``utils/eval_utils.eval_setup``, on the
CUDA device unless ``--device`` names another), takes each plane's L2 norm
over the feature axis, scales it to [0, 1] and writes it turbo-coloured as
``scale{i}_{XY,XZ,XT,YZ,YT,ZT}.png`` (``XY, XZ, YZ`` for a static model).

    python -m soccernerfs_tpu_torch.scripts.plot_kplane \\
        --load-config <run>/config.yml --out planes/
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from soccernerfs_tpu_torch.utils.colormaps import apply_colormap

PLANE_NAMES_4D = ["XY", "XZ", "XT", "YZ", "YT", "ZT"]
PLANE_NAMES_3D = ["XY", "XZ", "YZ"]


def plot_planes(grids, out: Path) -> None:
    """Write every plane of ``grids`` (scales of [H, W, F] planes, on any
    device) as ``out/scale{i}_{name}.png``."""
    from PIL import Image

    out.mkdir(parents=True, exist_ok=True)
    for scale_idx, planes in enumerate(grids):
        names = PLANE_NAMES_4D if len(planes) == 6 else PLANE_NAMES_3D
        for plane, name in zip(planes, names):
            mag = np.linalg.norm(plane.detach().cpu().numpy(), axis=-1)
            mag = (mag - mag.min()) / max(mag.max() - mag.min(), 1e-9)
            img = apply_colormap(mag)
            Image.fromarray((img * 255).astype(np.uint8)).save(
                out / f"scale{scale_idx}_{name}.png"
            )


def main(argv=None) -> Path:
    """Parse ``argv`` (``sys.argv[1:]`` by default) and write the planes;
    returns the output directory."""
    from soccernerfs_tpu_torch.utils.eval_utils import eval_setup

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--load-config", type=Path, required=True)
    p.add_argument("--out", type=Path, default=Path("planes"))
    p.add_argument("--device", default=None, help="default: cuda")
    args = p.parse_args(argv)

    _, trainer, step = eval_setup(args.load_config, "inference", device=args.device)
    plot_planes(trainer.state.params["fields"]["grids"], args.out)
    print(f"wrote plane visualizations to {args.out} (checkpoint step {step})")
    return args.out


if __name__ == "__main__":
    main()
