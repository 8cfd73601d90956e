"""DynMetric: PSNR, SSIM and LPIPS in boxes around the players and the ball
(counterpart of soccernerfs_tpu/utils/dynmetric.py).

The boxes come from, in order:
  1. a sidecar file named by the ``SNT_DYNMETRIC_BOXES`` environment
     variable (JSON: image name -> [{"box": [x1, y1, x2, y2], "label": 1
     for a person, else a ball}]), the JAX package's interface;
  2. torchvision's RetinaNet (person = 1, ball = 37, score > 0.6), only
     when torchvision imports and its weights are already in torch hub's
     cache: nothing is downloaded;
  3. else none, and the metrics are NaN (the reference's no-detection
     path).

The person box closest to the image centre is kept, every box is grown
by (w_factor 7, h_factor 2.5) around its centre and clamped to the image,
the metrics are computed per box on the given device and averaged
weighted by box size, LPIPS only over boxes of at least 32 px a side, and
a value below 1e-4 becomes NaN.
"""
from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from soccernerfs_tpu_torch.utils import metrics as M
from soccernerfs_tpu_torch.utils.device import resolve_device


def rescale_bbox(bbox, w_factor, h_factor, img_width, img_height):
    """A box grown around its centre, shifted back inside the image."""
    x1, y1, x2, y2 = bbox
    width, height = x2 - x1, y2 - y1
    new_width = int(width * w_factor)
    new_height = int(height * h_factor)
    x1 = max(0, x1 - (new_width - width) / 2)
    x2 = x1 + new_width
    y1 = max(0, y1 - (new_height - height) / 2)
    y2 = y1 + new_height
    if x2 > img_width:
        x1 -= x2 - img_width
        x2 = img_width
    if y2 > img_height:
        y1 -= y2 - img_height
        y2 = img_height
    return x1, y1, x2, y2


_detectors: Dict[str, object] = {}


def _cached_retinanet(device: torch.device):
    """RetinaNet on ``device`` from weights already in torch hub's cache;
    None when torchvision or the weights are missing."""
    try:
        from torchvision.models.detection import (
            RetinaNet_ResNet50_FPN_V2_Weights,
            retinanet_resnet50_fpn_v2,
        )
    except Exception:
        return None
    url = RetinaNet_ResNet50_FPN_V2_Weights.DEFAULT.url
    path = Path(torch.hub.get_dir()) / "checkpoints" / os.path.basename(url)
    if not path.exists():
        return None
    key = str(device)
    if key not in _detectors:
        model = retinanet_resnet50_fpn_v2(weights=None, weights_backbone=None)
        model.load_state_dict(torch.load(path, map_location="cpu",
                                         weights_only=True))
        _detectors[key] = model.eval().to(device)
    return _detectors[key]


def _detect_torchvision(image: torch.Tensor):
    model = _cached_retinanet(image.device)
    if model is None:
        return None
    with torch.no_grad():
        res = model([image.permute(2, 0, 1)])[0]
    keep = ((res["labels"] == 1) | (res["labels"] == 37)) & (res["scores"] > 0.6)
    return (res["boxes"][keep].cpu().numpy().tolist(),
            res["labels"][keep].cpu().numpy().tolist())


def _detect_sidecar(image_name: Optional[str]):
    path = os.environ.get("SNT_DYNMETRIC_BOXES", "")
    if not path or not os.path.exists(path) or image_name is None:
        return None
    table = json.loads(Path(path).read_text())
    entry = table.get(image_name)
    if entry is None:
        return None
    boxes = [e["box"] for e in entry]
    labels = [e.get("label", 1) for e in entry]
    return boxes, labels


class DynMetric:
    """Detection-gated metrics of an image pair, computed on ``device``
    (default CUDA; raises when CUDA is absent and the caller did not ask
    for another device)."""

    def __init__(self, w_factor: float = 7, h_factor: float = 2.5, device=None):
        self.w_factor = w_factor
        self.h_factor = h_factor
        self.device = resolve_device(device)

    def __call__(
        self,
        true_image: np.ndarray,
        pred_image: np.ndarray,
        image_name: Optional[str] = None,
    ) -> Tuple[np.ndarray, float, float, float]:
        """Args: [H, W, 3] images in [0, 1] (the ground truth first).
        Returns (the ground truth with the boxes drawn, dpsnr, dssim,
        dlpips)."""
        H, W = true_image.shape[:2]
        t_img = torch.as_tensor(np.asarray(true_image, np.float32)).to(self.device)
        det = _detect_sidecar(image_name) or _detect_torchvision(t_img)
        if det is None or len(det[0]) == 0:
            return true_image, float("nan"), float("nan"), float("nan")
        raw_boxes, labels = det
        p_img = torch.as_tensor(np.asarray(pred_image, np.float32)).to(self.device)

        person_boxes = [b for b, l in zip(raw_boxes, labels) if l == 1]
        ball_boxes = [b for b, l in zip(raw_boxes, labels) if l != 1]
        if len(person_boxes) > 1:
            person_boxes = [
                min(
                    person_boxes,
                    key=lambda b: ((b[0] + b[2]) / 2 - W / 2) ** 2
                    + ((b[1] + b[3]) / 2 - H / 2) ** 2,
                )
            ]
        boxes = [
            rescale_bbox(b, self.w_factor, self.h_factor, W, H)
            for b in person_boxes + ball_boxes
        ]

        box_sizes, lpips_sizes = [], []
        psnrs, ssims, lpipss = [], [], []
        for x1, y1, x2, y2 in boxes:
            x1, y1, x2, y2 = int(x1), int(y1), int(x2), int(y2)
            size = (x2 - x1) * (y2 - y1)
            if size <= 0:
                continue
            t = t_img[y1:y2, x1:x2]
            p = p_img[y1:y2, x1:x2]
            psnrs.append(float(M.psnr(t, p)))
            ssims.append(float(M.ssim(t, p)))
            box_sizes.append(size)
            if min(x2 - x1, y2 - y1) >= 32:
                lp = M.lpips(t, p)
                if not np.isnan(lp):
                    lpipss.append(lp)
                    lpips_sizes.append(size)

        annotated = _draw_boxes(true_image, boxes)
        if not box_sizes:
            return annotated, float("nan"), float("nan"), float("nan")
        dpsnr = float(np.average(psnrs, weights=box_sizes))
        dssim = float(np.average(ssims, weights=box_sizes))
        dlpips = float(np.average(lpipss, weights=lpips_sizes)) if lpipss else 0.0
        if dpsnr < 1e-4:
            dpsnr = float("nan")
        if dssim < 1e-4:
            dssim = float("nan")
        if dlpips < 1e-4:
            dlpips = float("nan")
        return annotated, dpsnr, dssim, dlpips


def _draw_boxes(image: np.ndarray, boxes: List, width: int = 2) -> np.ndarray:
    out = np.array(image, copy=True)
    H, W = out.shape[:2]
    for x1, y1, x2, y2 in boxes:
        x1, y1 = max(0, int(x1)), max(0, int(y1))
        x2, y2 = min(W - 1, int(x2)), min(H - 1, int(y2))
        out[y1 : y1 + width, x1:x2] = 0.0
        out[max(0, y2 - width) : y2, x1:x2] = 0.0
        out[y1:y2, x1 : x1 + width] = 0.0
        out[y1:y2, max(0, x2 - width) : x2] = 0.0
    return out
