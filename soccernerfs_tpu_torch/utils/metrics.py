"""Image quality metrics: PSNR, SSIM, LPIPS (counterpart of
soccernerfs_tpu/utils/metrics.py).

LPIPS needs pretrained AlexNet weights; they are read from a local .npz
named by the SNT_LPIPS_WEIGHTS environment variable (conv features and
linear heads, the JAX package's layout), and without them ``lpips`` is
NaN.  Nothing is downloaded.  ``all_image_metrics``, the entry point,
runs on CUDA unless the caller names a device.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from soccernerfs_tpu_torch.utils.device import full_f32, resolve_device


def psnr(pred: torch.Tensor, target: torch.Tensor, data_range: float = 1.0
         ) -> torch.Tensor:
    """Peak signal-to-noise ratio, a 0-d tensor."""
    mse = torch.mean((pred - target) ** 2)
    return 10.0 * torch.log10(data_range**2 / torch.clamp(mse, min=1e-12))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5, device=None
                     ) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    g = torch.exp(-(x**2) / (2 * sigma**2))
    g = g / g.sum()
    return torch.outer(g, g)


def ssim(pred: torch.Tensor, target: torch.Tensor, data_range: float = 1.0
         ) -> torch.Tensor:
    """Structural similarity with the 11x11, sigma 1.5 Gaussian window,
    averaged over the windows that lie inside the image (torchmetrics'
    value).

    The window convolutions run in full f32, TF32 off: the variance terms
    E[x^2] - mu^2 cancel (values ~1, variances ~1e-4), and TF32's 10-bit
    mantissa gives SSIM errors up to ~0.2, as bf16 convolutions did on the
    TPU.

    Args:
        pred, target: [H, W, C] in [0, data_range].
    Returns:
        a 0-d tensor; NaN when no window fits (a side under 11 px), the
        mean over no windows, as the JAX package's.
    """
    if min(pred.shape[0], pred.shape[1]) < 11:
        return torch.full((), float("nan"), device=pred.device)
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    kernel = _gaussian_kernel(device=pred.device)[None, None]  # [1, 1, 11, 11]

    def filt(x):
        return F.conv2d(x.permute(2, 0, 1)[:, None], kernel)[:, 0]

    with full_f32():
        mu_x = filt(pred)
        mu_y = filt(target)
        mu_xx = filt(pred * pred) - mu_x**2
        mu_yy = filt(target * target) - mu_y**2
        mu_xy = filt(pred * target) - mu_x * mu_y
    num = (2 * mu_x * mu_y + c1) * (2 * mu_xy + c2)
    den = (mu_x**2 + mu_y**2 + c1) * (mu_xx + mu_yy + c2)
    return torch.mean(num / den)


_ALEX_LAYERS = [  # (out_ch, kernel, stride, pad)
    (64, 11, 4, 2),
    (192, 5, 1, 2),
    (384, 3, 1, 1),
    (256, 3, 1, 1),
    (256, 3, 1, 1),
]
_POOL_AFTER = {0, 1}  # max-pool after conv0 and conv1; features before it


_lpips_weights_cache: Dict[tuple, Dict[str, torch.Tensor]] = {}


def _load_lpips_weights(device) -> Optional[Dict[str, torch.Tensor]]:
    """The weights of SNT_LPIPS_WEIGHTS on ``device``, read once per path
    and device; None without the file."""
    path = os.environ.get("SNT_LPIPS_WEIGHTS", "")
    if not path or not os.path.exists(path):
        return None
    key = (path, str(device))
    if key not in _lpips_weights_cache:
        with np.load(path) as data:
            _lpips_weights_cache[key] = {
                k: torch.from_numpy(np.asarray(v)).to(device)
                for k, v in data.items()}
    return _lpips_weights_cache[key]


def lpips(pred: torch.Tensor, target: torch.Tensor) -> float:
    """LPIPS (AlexNet) of [H, W, 3] images in [0, 1]; NaN without local
    weights."""
    weights = _load_lpips_weights(pred.device)
    if weights is None:
        return float("nan")
    shift = torch.tensor([-0.030, -0.088, -0.188], device=pred.device)
    scale = torch.tensor([0.458, 0.448, 0.450], device=pred.device)

    def features(img):
        x = ((img * 2.0 - 1.0 - shift) / scale).permute(2, 0, 1)[None]
        feats = []
        for i, (_, _, stride, pad) in enumerate(_ALEX_LAYERS):
            x = F.relu(F.conv2d(x, weights[f"conv{i}_w"], weights[f"conv{i}_b"],
                                stride=stride, padding=pad))
            feats.append(x)
            if i in _POOL_AFTER:
                x = F.max_pool2d(x, 3, 2)
        return feats

    with full_f32():
        total = 0.0
        for i, (a, b) in enumerate(zip(features(pred), features(target))):
            a = a / torch.clamp(torch.linalg.vector_norm(a, dim=1, keepdim=True), min=1e-10)
            b = b / torch.clamp(torch.linalg.vector_norm(b, dim=1, keepdim=True), min=1e-10)
            total += float(torch.mean(torch.sum((a - b) ** 2 * weights[f"lin{i}_w"],
                                                dim=1)))
    return total


def all_image_metrics(pred, target, device=None) -> dict:
    """psnr, ssim and lpips (floats) of one [H, W, 3] image pair (tensors
    or arrays), computed on ``device`` (CUDA unless the caller names one;
    raises when CUDA is absent)."""
    dev = resolve_device(device)
    p = torch.as_tensor(pred, dtype=torch.float32).to(dev)
    t = torch.as_tensor(target, dtype=torch.float32).to(dev)
    return {"psnr": float(psnr(p, t)), "ssim": float(ssim(p, t)),
            "lpips": lpips(p, t)}
