"""Eval-image metrics averaged over the eval split, over a set-up Trainer
(counterpart of ``average_eval_image_metrics`` in the JAX package's
``scripts/eval.py``).  ``DynamicBatchPipeline``'s behaviour is the
trainer's ``pipeline.dynamic_batch``.
"""
from __future__ import annotations

import time

import numpy as np

from soccernerfs_tpu_torch.utils import metrics as M
from soccernerfs_tpu_torch.utils.dynmetric import DynMetric


def average_eval_image_metrics(trainer, use_dynmetric: bool = False) -> dict:
    """psnr, ssim and lpips averaged over every eval image (computed on the
    trainer's device), with the render rate; with ``use_dynmetric`` (as
    snt-eval runs it) also DynMetric's dpsnr, dssim and dlpips.  A metric
    that is NaN on every image (lpips without local weights, the D-metrics
    without boxes) is reported as None."""
    dynmetric = DynMetric(device=trainer.device) if use_dynmetric else None
    per_image = []
    num_rays = 0
    t0 = time.time()
    dm = trainer.datamanager
    for idx in range(len(dm.eval_dataset)):
        _, _, batch = dm.next_eval_image(idx)
        outputs = trainer.render_camera(trainer.eval_cameras, idx)
        gt = np.asarray(batch["image"], np.float32)
        m = M.all_image_metrics(outputs["rgb"], gt, device=trainer.device)
        if dynmetric is not None:
            name = dm.eval_dataset.image_filenames[idx].name
            _, dpsnr, dssim, dlpips = dynmetric(gt, outputs["rgb"], image_name=name)
            m.update({"dpsnr": dpsnr, "dssim": dssim, "dlpips": dlpips})
        per_image.append(m)
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
