"""The work a temporal hash-grid step needs (nerfplayer-nerfacto), counted
from the configuration's shapes and from the sample points themselves:
model FLOPs, and the least bytes of the hash tables' gradient.  The grids,
corner rows and temporal channels a point touches are those of the
configuration's plain reference (``ref``, nerfbench/reference/<config>.py),
which works them out as the configuration defines them."""
from __future__ import annotations

from typing import Dict

from types import ModuleType

from nerfbench.metrics.work import mlp_flops


def interp_flops(levels: int, level_dim: int) -> int:
    """One point's temporal hash features: per level and corner two picks
    of each of its channels weighted and summed, then the picks' time
    weights."""
    return levels * (8 * 2 * 2 * level_dim + 2 * 2 * level_dim)


def levels_of(c: dict, ref: ModuleType) -> list:
    """Per sampling level, proposals first: its grid, samples a ray, MLP
    widths."""
    gs = ref.grids(c)
    out = []
    for i, (count, args) in enumerate(zip(c["num_proposal_samples_per_ray"],
                                          c["proposal_net_args_list"])):
        g = gs[i + 1]
        out.append({"grid": g, "samples": count, "proposal": True,
                    "mlps": [[g["levels"] * g["level_dim"], args["hidden_dim"], 1]]})
    widths = ref.mlp_widths({"config": c})
    out.append({"grid": gs[0], "samples": c["num_nerf_samples_per_ray"], "proposal": False,
                "mlps": [widths["mlp_base_decode"], widths["mlp_head"]]})
    return out


def level_flops(level: dict) -> int:
    g = level["grid"]
    return interp_flops(g["levels"], g["level_dim"]) + sum(mlp_flops(d) for d in level["mlps"])


def hash_flops(c: dict, ref: ModuleType, rays: int, *, train: bool,
               update: bool = True) -> float:
    total = 0.0
    for level in levels_of(c, ref):
        fwd = level_flops(level) * level["samples"] * rays
        back = train and (update or not level["proposal"])
        total += fwd * (3 if back else 1)
    return total


class Counter:
    """The distinct table entries (row, channel) whose gradient a step's
    points write: per sampling level, each corner row's picked channels
    whose time weight is not 0.  A bitmap per level's table."""

    def __init__(self, c: dict, device, ref: ModuleType):
        import torch

        self.ref = ref
        self.levels = levels_of(c, ref)
        self.points = [0] * len(self.levels)
        self.maps = [torch.zeros(ref.layout(lv["grid"])[0][-1]
                                 * (lv["grid"]["level_dim"] + lv["grid"]["temporal"]),
                                 dtype=torch.bool, device=device) for lv in self.levels]

    def add(self, level: int, pts) -> None:
        """``pts``: (positions [M, 3] in [0, 1], times [M])."""
        ref = self.ref
        xyz, times = pts
        g = self.levels[level]["grid"]
        width = g["level_dim"] + g["temporal"]
        self.points[level] += xyz.shape[0]
        ch, tw = ref.time_picks(g, times)                  # [B, C, 2]
        live = (tw != 0)
        for idx, _w in ref.corner_rows(g, xyz):
            for k in range(8):
                entries = idx[k][:, None, None] * width + ch
                self.maps[level][entries[live]] = True

    def entries(self, level: int) -> int:
        return int(self.maps[level].sum())


def unit_work(c: dict, counter: Counter, rays: int, *, train: bool,
              update: bool = True) -> Dict[str, float]:
    """One step's counts: "hash_grad_bytes", the least bytes of the hash
    tables' gradient on the levels that take one (each point's feature
    gradient and its position and time read once, each distinct entry's
    gradient written once, f32), and "model_flops"."""
    total = 0.0
    for lv, level in enumerate(counter.levels):
        if not (train and (update or not level["proposal"])):
            continue
        g = level["grid"]
        total += counter.points[lv] * (g["levels"] * g["level_dim"] * 4 + 16)
        total += counter.entries(lv) * 4
    return {"hash_grad_bytes": total,
            "model_flops": hash_flops(c, counter.ref, rays, train=train, update=update)}
