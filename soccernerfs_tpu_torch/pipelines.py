"""Eval-image metrics averaged over the eval split, over a set-up Trainer
(counterpart of ``average_eval_image_metrics`` in the JAX package's
``scripts/eval.py``, without DynMetric).  ``DynamicBatchPipeline``'s behaviour is the trainer's
``pipeline.dynamic_batch``.
"""
from __future__ import annotations

import time

import numpy as np

from soccernerfs_tpu_torch.utils import metrics as M


def average_eval_image_metrics(trainer) -> dict:
    """psnr, ssim and lpips averaged over every eval image (computed on the
    trainer's device), with the render rate.  A metric that is NaN on
    every image (lpips without local weights) is reported as None."""
    per_image = []
    num_rays = 0
    t0 = time.time()
    dm = trainer.datamanager
    for idx in range(len(dm.eval_dataset)):
        _, _, batch = dm.next_eval_image(idx)
        outputs = trainer.render_camera(trainer.eval_cameras, idx)
        gt = np.asarray(batch["image"], np.float32)
        per_image.append(M.all_image_metrics(outputs["rgb"], gt,
                                             device=trainer.device))
        num_rays += gt.shape[0] * gt.shape[1]
    dt = time.time() - t0

    metrics: dict = {}
    unavailable = []
    for k in per_image[0]:
        vals = np.asarray([m[k] for m in per_image], np.float64)
        finite = vals[np.isfinite(vals)]
        if finite.size == 0:
            metrics[k] = None
            unavailable.append(k)
        else:
            metrics[k] = float(finite.mean())
    if unavailable:
        print("note: metrics unavailable in this environment (no pretrained "
              f"weights): {', '.join(unavailable)} — reported as null")
    metrics["num_rays_per_sec"] = num_rays / dt
    metrics["fps"] = len(per_image) / dt
    return metrics
