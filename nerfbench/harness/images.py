"""What the render cells share: the reference's render of chosen pixels,
the numbers compared, and the traced frames' work."""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from nerfbench.harness import spec

BLOCK = 32768


def reference_pixels(ctx, params, pose, time, cam: dict, pixels: torch.Tensor,
                     dtype=torch.float32, counter=None) -> Dict[str, torch.Tensor]:
    """The reference's rgb, accumulation and depth at flat pixel indices
    ``pixels`` of one camera (pose [3, 4], ``time``, ``cam``: height,
    width, focal), in blocks; with ``counter`` (the work module's) each
    level's points are counted."""
    dev = torch.device(ctx.device)
    ref = ctx.reference
    h, w, f = cam["height"], cam["width"], cam["focal"]
    pose_t = torch.as_tensor(np.asarray(pose, np.float32), device=dev)
    outs = {"rgb": [], "accumulation": [], "depth": []}
    with torch.no_grad():
        for s in range(0, pixels.shape[0], BLOCK):
            p = pixels[s:s + BLOCK].to(dev)
            n = p.shape[0]
            coords = torch.stack([(p // w).float(), (p % w).float()], -1) + 0.5
            full = lambda v: torch.full((n,), float(v), device=dev)
            o, d, t = ref.rays(pose_t.expand(n, 3, 4), full(f), full(f), full(w / 2),
                               full(h / 2), full(time), coords)
            out = ref.forward(ctx.cfg, params, o, d, t, train=False, dtype=dtype,
                              keep_points=counter is not None)
            if counter is not None:
                for lv, pts in enumerate(out["points"]):
                    counter.add(lv, pts)
            for k in outs:
                outs[k].append(out[k].float())
    return {k: torch.cat(v) for k, v in outs.items()}


def pixels_of(out: Dict[str, torch.Tensor], pixels) -> Dict[str, torch.Tensor]:
    """A rendered image's outputs at flat pixel indices."""
    return {k: out[k].reshape(-1, *out[k].shape[2:])[pixels]
            for k in ("rgb", "accumulation", "depth")}


def numbers(program: List[Dict[str, torch.Tensor]], reference: List[Dict[str, torch.Tensor]]
            ) -> dict:
    """Over every compared pixel: rgb_gap, the widest gap of a channel;
    rgb_mean_gap, the mean gap; acc_gap, the widest gap of the
    accumulation; depth_share, the share of pixels whose median depth
    differs by more than 1e-2 (about a fifth of a field sample's spacing
    across the scene box)."""
    dev = reference[0]["rgb"].device
    cat = lambda side, k: torch.cat([x[k].to(dev).float().reshape(-1) for x in side])
    rgb = (cat(program, "rgb") - cat(reference, "rgb")).abs()
    acc = (cat(program, "accumulation") - cat(reference, "accumulation")).abs()
    depth = (cat(program, "depth") - cat(reference, "depth")).abs()
    bad = lambda t: bool((~torch.isfinite(t)).any())
    nan = float("nan")
    return {
        "rgb_gap": nan if bad(rgb) else float(rgb.max()),
        "rgb_mean_gap": nan if bad(rgb) else float(rgb.mean()),
        "acc_gap": nan if bad(acc) else float(acc.max()),
        "depth_share": nan if bad(depth) else float((depth > 1e-2).float().mean()),
    }


def frame_work(ctx, params, pose, time, cam: dict) -> dict:
    """One whole frame's counts (the configuration's work module), from
    its sample points, which the reference works out."""
    c = ctx.cfg["config"]
    work = spec.work(ctx.cfg)
    counter = work.Counter(c, torch.device(ctx.device), ctx.reference)
    pixels = torch.arange(cam["height"] * cam["width"])
    reference_pixels(ctx, params, pose, time, cam, pixels, counter=counter)
    return work.unit_work(c, counter, pixels.shape[0], train=False)


def add_work(total: dict, part: dict) -> dict:
    return {k: total.get(k, 0.0) + v for k, v in part.items()}


def finite(out: Dict[str, torch.Tensor]) -> bool:
    return all(bool(torch.isfinite(v).all()) for v in out.values())
