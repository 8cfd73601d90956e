"""snt-eval: a trained run's metrics to JSON (counterpart of
soccernerfs_tpu/scripts/eval.py).

    python -m soccernerfs_tpu_torch.scripts.eval \
        --load-config outputs/<exp>/<method>/<ts>/config.yml \
        --output-path results.json

Renders every eval image and writes psnr / ssim / lpips, DynMetric's
dpsnr / dssim / dlpips (boxes from ``SNT_DYNMETRIC_BOXES``; null without
them) and the render rate, in ns-eval's JSON shape.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from soccernerfs_tpu_torch.pipelines import average_eval_image_metrics
from soccernerfs_tpu_torch.utils.eval_utils import eval_setup


def main(argv=None, device=None) -> dict:
    """Evaluate the run of ``--load-config``; returns the JSON written.
    ``device``: default CUDA; raises when CUDA is absent and the caller
    did not ask for another device."""
    parser = argparse.ArgumentParser("snt-eval")
    parser.add_argument("--load-config", type=Path, required=True)
    parser.add_argument("--output-path", type=Path, default=Path("output.json"))
    parser.add_argument("--load-step", type=int, default=None)
    parser.add_argument("--no-dynmetric", action="store_true")
    args = parser.parse_args(argv)

    config, trainer, step = eval_setup(args.load_config, "test", args.load_step,
                                       device=device)
    metrics = average_eval_image_metrics(trainer,
                                         use_dynmetric=not args.no_dynmetric)
    benchmark_info = {
        "experiment_name": config.experiment_name,
        "method_name": config.method_name,
        "checkpoint": str(step),
        "results": metrics,
    }
    args.output_path.parent.mkdir(parents=True, exist_ok=True)
    args.output_path.write_text(json.dumps(benchmark_info, indent=2), "utf8")
    print(f"saved metrics to {args.output_path}")
    print(json.dumps(metrics, indent=2))
    return benchmark_info


if __name__ == "__main__":
    main()
