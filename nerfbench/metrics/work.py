"""The work a K-Planes step or frame needs, counted from the configuration's
shapes and from the sample points themselves, never from the program's
internals: model FLOPs, and the least bytes of the plane lookups.  Each
count depends on the work, not on the kernel that does it.

A configuration's file names its work module ("work"); each has a
``Counter`` of the sample points of one step or frame (level by level,
in blocks) and ``unit_work``, the counts the readers read.

H100 SXM peaks (NVIDIA's data sheet, dense, at the 700 W limit):
989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s f32 outside them,
3.35 TB/s HBM3.
"""
from __future__ import annotations

import itertools
from typing import Dict, List, Sequence, Tuple

H100_BF16_FLOPS = 989e12
H100_F32_FLOPS = 67e12
H100_BYTES_PER_S = 3.35e12

COMBOS = list(itertools.combinations(range(4), 2))
GEO_FEAT_DIM = 15


def mlp_flops(dims: Sequence[int]) -> int:
    """Multiply-adds of one point through an MLP of layer widths ``dims``,
    two FLOPs each."""
    return 2 * sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def interp_flops(feat: int) -> int:
    """One plane's bilinear sample of ``feat`` features (three lerps of
    three operations) and its product into the scale's running one."""
    return 10 * feat


def kplanes_levels(c: dict) -> List[dict]:
    """Per sampling level, proposals first: its samples per ray, planes
    (c1, c2, height, width, features) per scale, and MLP widths."""
    levels = []
    for count, args in zip(c["num_proposal_samples_per_ray"], c["proposal_net_args_list"]):
        res, feat = args["resolution"], args["feature_dim"]
        levels.append({"samples": count,
                       "scales": [[(c1, c2, res[c2], res[c1], feat) for c1, c2 in COMBOS]],
                       "mlps": [[feat, 64, 1]], "proposal": True})
    res = c["spacetime_resolution"]
    scales = []
    for m in c["multiscale_res"]:
        r = [x * m for x in res[:3]] + [res[3]]
        scales.append([(c1, c2, r[c2], r[c1], c["feature_dim"]) for c1, c2 in COMBOS])
    feat = c["feature_dim"] * len(c["multiscale_res"])
    levels.append({"samples": c["num_nerf_samples_per_ray"], "scales": scales,
                   "mlps": [[feat] + [c["sigma_net_hidden_dim"]] * c["sigma_net_layers"]
                            + [GEO_FEAT_DIM + 1],
                            [GEO_FEAT_DIM] + [c["rgb_net_hidden_dim"]] * c["rgb_net_layers"]
                            + [3]],
                   "proposal": False})
    return levels


def level_flops(level: dict) -> int:
    """Forward FLOPs of one sample of a level."""
    planes = sum(interp_flops(p[4]) for scale in level["scales"] for p in scale)
    return planes + sum(mlp_flops(d) for d in level["mlps"])


def kplanes_flops(c: dict, rays: int, *, train: bool, update_proposals: bool = True) -> float:
    """Model FLOPs of a step (``train``: forward once, backward twice; the
    proposal levels' backward only when they update) or of a forward over
    ``rays`` rays."""
    total = 0.0
    for level in kplanes_levels(c):
        fwd = level_flops(level) * level["samples"] * rays
        back = train and (update_proposals or not level["proposal"])
        total += fwd * (3 if back else 1)
    return total


class RowCounter:
    """The distinct table rows that sample points touch, per level, scale
    and plane: a bitmap per plane, so that points may come in any number
    of blocks (a frame's chunks)."""

    def __init__(self, levels: List[dict], device):
        import torch

        self.levels = levels
        self.points = [0] * len(levels)
        self.maps = [[[torch.zeros(h * w, dtype=torch.bool, device=device)
                       for _c1, _c2, h, w, _f in scale] for scale in lv["scales"]]
                     for lv in levels]

    def add(self, level: int, pts) -> None:
        """``pts`` [M, 4] normalised (x, y, z, t) in [-1, 1]."""
        self.points[level] += pts.shape[0]
        for scale, maps in zip(self.levels[level]["scales"], self.maps[level]):
            for (c1, c2, h, w, _f), bitmap in zip(scale, maps):
                for rows in corner_rows(pts[:, c1], pts[:, c2], h, w):
                    bitmap[rows] = True

    def rows(self, level: int) -> List[List[int]]:
        return [[int(b.sum()) for b in maps] for maps in self.maps[level]]


def corner_rows(x, y, h: int, w: int):
    """The four corner rows (y * w + x) a bilinear sample at x, y in
    [-1, 1] reads, align_corners and border clamped."""
    import torch

    def axis(c, size):
        v = torch.clamp((c + 1.0) * 0.5 * (size - 1), 0.0, size - 1)
        i0 = torch.floor(v).long()
        return i0, torch.clamp(i0 + 1, max=size - 1)

    x0, x1 = axis(x.float(), w)
    y0, y1 = axis(y.float(), h)
    return (y0 * w + x0, y0 * w + x1, y1 * w + x0, y1 * w + x1)


def lookup_bytes(counter: RowCounter, backward: Sequence[bool],
                 table_bytes: int = 2, value_bytes: int = 4) -> Tuple[float, float]:
    """(least bytes, FLOPs) of every plane lookup the counted points made,
    and of its gradient on the levels where ``backward`` holds: per level
    its coordinates once (4 values a point); per scale each plane's
    distinct rows once (bf16 tables) and the scale's features once; the
    backward reads the features' gradient once and writes each distinct
    row's gradient once (f32)."""
    total_bytes = total_flops = 0.0
    for lv, (level, back) in enumerate(zip(counter.levels, backward)):
        m = counter.points[lv]
        passes = 2 if back else 1
        total_bytes += passes * m * 4 * value_bytes
        for scale, rows in zip(level["scales"], counter.rows(lv)):
            feat = scale[0][4]
            total_bytes += sum(r * feat * table_bytes for r in rows) + m * feat * value_bytes
            total_flops += m * sum(interp_flops(p[4]) for p in scale)
            if back:
                total_bytes += m * feat * value_bytes + sum(r * feat * value_bytes for r in rows)
                total_flops += m * sum(2 * interp_flops(p[4]) for p in scale)
    return total_bytes, total_flops


def roofline_share(nbytes: float, flops: float, seconds: float,
                   flops_peak: float = H100_F32_FLOPS) -> float:
    """Least time (the larger of bytes at the memory rate and FLOPs at the
    peak) over the measured time, in %."""
    least = max(nbytes / H100_BYTES_PER_S, flops / flops_peak)
    return 100.0 * least / seconds


class Counter(RowCounter):
    """The counter of a configuration ``c`` (its plain reference ``ref``
    is not needed: the planes' rows follow from the shapes alone)."""

    def __init__(self, c: dict, device, ref=None):
        super().__init__(kplanes_levels(c), device)


def unit_work(c: dict, counter: Counter, rays: int, *, train: bool,
              update: bool = True) -> Dict[str, float]:
    """One step's (``train``) or frame's counts: "plane_bytes" and
    "plane_flops" of its lookups (and their gradients where the step
    takes them), "model_flops"."""
    back = [train and (update or not lv["proposal"]) for lv in counter.levels]
    b, f = lookup_bytes(counter, back)
    return {"plane_bytes": b, "plane_flops": f,
            "model_flops": kplanes_flops(c, rays, train=train, update_proposals=update)}
