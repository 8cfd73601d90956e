"""The byte and FLOP counters against brute-force counts at a tiny size."""
import math

import pytest
import torch

from nerfbench.harness import spec
from nerfbench.metrics import work, work_hash
from nerfbench.tests.tiny import CONFIG

TINY = {"spacetime_resolution": [4, 5, 6, 3], "multiscale_res": [1, 2], "feature_dim": 4,
        "proposal_net_args_list": [{"feature_dim": 2, "resolution": [3, 4, 5, 3]}],
        "num_proposal_samples_per_ray": [6], "num_nerf_samples_per_ray": 5,
        "sigma_net_layers": 1, "sigma_net_hidden_dim": 7, "rgb_net_layers": 2,
        "rgb_net_hidden_dim": 3}


def brute_rows(pts, c1, c2, h, w):
    rows = set()
    for p in pts.tolist():
        def cell(c, size):
            v = min(max((c + 1.0) * 0.5 * (size - 1), 0.0), size - 1)
            i = math.floor(v)
            return i, min(i + 1, size - 1)
        x0, x1 = cell(p[c1], w)
        y0, y1 = cell(p[c2], h)
        rows |= {y0 * w + x0, y0 * w + x1, y1 * w + x0, y1 * w + x1}
    return len(rows)


def points(n, seed):
    g = torch.Generator().manual_seed(seed)
    # some points beyond [-1, 1], clamped to the border
    return torch.rand((n, 4), generator=g) * 2.4 - 1.2


def test_distinct_rows_match_a_brute_force_count():
    levels = work.kplanes_levels(TINY)
    counter = work.RowCounter(levels, "cpu")
    pts = [points(37, 1), points(29, 2)]
    counter.add(0, pts[0][:20])
    counter.add(0, pts[0][20:])        # blocks accumulate
    counter.add(1, pts[1])
    for lv, p in enumerate(pts):
        for scale, rows in zip(levels[lv]["scales"], counter.rows(lv)):
            assert rows == [brute_rows(p, c1, c2, h, w) for c1, c2, h, w, _f in scale]
    assert counter.points == [37, 29]


def test_lookup_bytes_count_each_part_once():
    levels = work.kplanes_levels(TINY)
    counter = work.RowCounter(levels, "cpu")
    pts = [points(37, 3), points(29, 4)]
    for lv, p in enumerate(pts):
        counter.add(lv, p)
    fwd = bwd = 0
    flops_f = flops_b = 0
    for lv, p in enumerate(pts):
        m = p.shape[0]
        fwd += m * 16
        bwd += m * 16 if lv == 1 else 0
        for scale in levels[lv]["scales"]:
            f = scale[0][4]
            rows = [brute_rows(p, c1, c2, h, w) for c1, c2, h, w, _f in scale]
            fwd += sum(rows) * f * 2 + m * f * 4
            flops_f += m * len(scale) * 10 * f
            if lv == 1:
                bwd += m * f * 4 + sum(rows) * f * 4
                flops_b += m * len(scale) * 20 * f
    b, fl = work.lookup_bytes(counter, [False, True])
    assert b == fwd + bwd and fl == flops_f + flops_b


def test_model_flops_by_hand():
    prop = 6 * 10 * 2 + 2 * (2 * 64 + 64 * 1)
    field = 2 * 6 * 10 * 4 + 2 * (8 * 7 + 7 * 16) + 2 * (15 * 3 + 3 * 3 + 3 * 3)
    assert work.level_flops(work.kplanes_levels(TINY)[0]) == prop
    assert work.level_flops(work.kplanes_levels(TINY)[1]) == field
    rays = 11
    assert work.kplanes_flops(TINY, rays, train=False) == rays * (6 * prop + 5 * field)
    assert work.kplanes_flops(TINY, rays, train=True) == 3 * rays * (6 * prop + 5 * field)
    assert work.kplanes_flops(TINY, rays, train=True, update_proposals=False) == \
        rays * (6 * prop + 3 * 5 * field)


def test_roofline_share_takes_the_larger_bound():
    assert work.roofline_share(3.35e12, 0, 2.0) == pytest.approx(50.0)
    assert work.roofline_share(0, work.H100_F32_FLOPS, 4.0) == pytest.approx(25.0)


def test_hash_entries_match_a_brute_force_count():
    """The distinct (row, channel) entries of a temporal hash grid whose
    gradient the points write, from the reference the counter is given."""
    ref = spec.reference("nerfplayer-nerfacto")
    c = {**spec.config("nerfplayer-nerfacto")["config"], **CONFIG["nerfplayer-nerfacto"]}
    counter = work_hash.Counter(c, "cpu", ref)
    g = torch.Generator().manual_seed(5)
    xyz, t = torch.rand((23, 3), generator=g), torch.rand(23, generator=g)
    counter.add(0, (xyz[:10], t[:10]))
    counter.add(0, (xyz[10:], t[10:]))           # blocks accumulate
    grid = counter.levels[0]["grid"]
    width = grid["level_dim"] + grid["temporal"]
    ch, tw = ref.time_picks(grid, t)
    entries = set()
    for idx, _w in ref.corner_rows(grid, xyz):
        for k in range(8):
            for b in range(23):
                for j in range(ch.shape[1]):
                    for p in range(2):
                        if tw[b, j, p] != 0:
                            entries.add(int(idx[k, b]) * width + int(ch[b, j, p]))
    assert counter.points[0] == 23 and counter.entries(0) == len(entries)
    got = work_hash.unit_work(c, counter, 5, train=True)
    assert got["hash_grad_bytes"] == 23 * (grid["levels"] * grid["level_dim"] * 4 + 16) \
        + 4 * len(entries)
    assert got["model_flops"] == work_hash.hash_flops(c, ref, 5, train=True)
