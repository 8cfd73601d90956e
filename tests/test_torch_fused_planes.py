"""The K-Planes render path's fused plane forward (``kplanes_fwd_fused``,
one launch per scale) through its plain version on the CPU, against the
JAX package's ``interpolate_kplanes`` and against the per-plane route it
replaces.

The CUDA kernel runs only on the card (tests/test_torch_cuda_kernels.py
and chip_smoke.py hold it to this plain version there); here the wrapper
takes its plain version because the tensors lie on the CPU.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from soccernerfs_tpu.fields import kplanes as jkpf
from soccernerfs_tpu.ops import grid_sample as jgs
from soccernerfs_tpu_torch.fields import kplanes as tkpf
from soccernerfs_tpu_torch.ops import grid_sample as tgs
from soccernerfs_tpu_torch.ops.kernels import plane_kernels as tpk


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch CPU thread while this file runs.  The suite runs in
    parallel worker processes; a full-width torch thread pool in each of
    them oversubscribes the cores, and its threads' spin-waiting then slows
    these many small ops by two orders of magnitude."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _quad(plane: torch.Tensor) -> torch.Tensor:
    """A staged quad-packed bf16 table [h*w, 4F] of an [h, w, F] plane."""
    return tgs.quad_pack(plane.to(torch.bfloat16)).contiguous()


def _grids(rng, reso, mults, feat):
    """Scales of k-choose-2 planes [res_c2, res_c1, F] in U(0.1, 0.5), the
    space resolutions scaled by each multiplier, time kept."""
    out = []
    for mult in mults:
        r = [x * mult for x in reso[:3]] + list(reso[3:])
        out.append([rng.uniform(0.1, 0.5, (r[c2], r[c1], feat)).astype(np.float32)
                    for c1, c2 in tkpf.plane_combinations(len(reso))])
    return out


def _points(rng, m, dim):
    """Points in [-1.1, 1.1]^dim: some beyond +-1 on every axis, the first
    rows exactly at -1 or +1 on every axis, then rows mixing both."""
    pts = rng.uniform(-1.1, 1.1, (m, dim)).astype(np.float32)
    pts[0], pts[1] = -1.0, 1.0
    pts[2:10] = rng.choice([-1.0, 1.0], (8, dim))
    pts[10:14] = rng.choice([-1.1, 1.1], (4, dim))
    return pts


# (reso, multiscale, F, query dim, concat, freeze_time_planes, staged kinds
#  at the finest scale: 32 = an unpacked [h*w, F] table, 128 / 32 = packed)
CASES = {
    # the finest scale's 256x256 space planes stage unpacked, its time
    # planes and the coarser scales' quad-packed: one launch, both layouts
    "3 scales, F 32, mixed layouts, concat": (
        (64, 64, 64, 5), (1, 2, 4), 32, 4, True, False, {32, 128}),
    "2 scales, F 32, summed": ((32, 16, 24, 6), (1, 2), 32, 4, False, False,
                               {128}),
    "F 8 proposal field": ((24, 20, 16, 6), (1,), 8, 4, False, False, {32}),
    "3D query of 4D grids": ((64, 64, 64, 5), (1, 4), 32, 3, True, False,
                             {32, 128}),
    "freeze_time_planes": ((64, 64, 64, 5), (1, 4), 32, 4, True, True,
                           {32, 128}),
    "static 3D grids, F 8, summed": ((16, 24, 20), (1, 2), 8, 3, False, False,
                                     {32}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_fused_render_branch_matches_jax(case):
    """interpolate_kplanes over staged tables (one fused launch per scale,
    its plain version here) == JAX's unsorted interpolate_kplanes, 1e-5 of
    the max: the same bf16 table values and f32 lerps, the planes
    multiplied in JAX's order.  On this CPU every case agrees bit for bit;
    the group order the train path multiplies in (XY, XZ, YZ, XT, YT, ZT
    when widths match) left 1.3e-7 of the max in the first case.  The bar
    stays 1e-5, for XLA's own evaluation order of the lerp elsewhere."""
    reso, mults, feat, dim, concat, freeze, kinds = CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    grids = _grids(rng, reso, mults, feat)
    pts = _points(rng, 600, dim)
    kw = dict(concat_features=concat, freeze_time_planes=freeze)
    want = np.asarray(jkpf.interpolate_kplanes(
        jnp.asarray(pts), [[jnp.asarray(g) for g in gs] for gs in grids], **kw))
    tgrids = [[_t(g) for g in gs] for gs in grids]
    staged = tkpf.pack_grids_for_render({"grids": tgrids})["grids_packed"]
    assert {t.shape[-1] for t in staged[-1]} == kinds
    tpk.reset_launch_counts()
    got = tkpf.interpolate_kplanes(_t(pts), tgrids, ms_packed=staged, **kw)
    assert tpk.kplanes_fwd_fused.launches == 0      # plain versions on the CPU
    assert got.shape == want.shape == (600, feat * (len(mults) if concat else 1))
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy() / scale, want / scale, atol=1e-5)


def _old_route(pts, tables, planes, feat):
    """The route the fused kernel replaces, per plane: JAX's grid_coords
    for its two axes, the row id, the per-plane kernel's plain version of
    its layout, and the in-place product in the planes' order."""
    acc = None
    for table, (c1, c2, h, w) in zip(tables, planes):
        xc, tx = (np.asarray(a) for a in jgs.grid_coords(jnp.asarray(pts[:, c1]), w))
        yc, ty = (np.asarray(a) for a in jgs.grid_coords(jnp.asarray(pts[:, c2]), h))
        rowid, tx, ty = _t(yc * w + xc), _t(tx), _t(ty)
        if table.shape[1] == feat:
            (f,) = tpk.bilerp_fwd_unpacked_plain([table], [rowid], [tx], ty,
                                                 h=h, w=w)
        else:
            (f,) = tpk.bilerp_fwd_packed_plain([table], [rowid], [tx], ty)
        acc = f if acc is None else acc.mul_(f)
    return acc


@pytest.mark.parametrize("feat,dim", [(32, 4), (32, 3), (8, 4), (8, 3)])
def test_fused_plain_equals_the_old_route_bit_for_bit(feat, dim):
    """kplanes_fwd_fused's plain version derives each plane's cells and
    fractions itself; with JAX's grid_coords' cells and fractions fed to
    the per-plane plain versions instead, every feature is bit-equal, on
    both layouts in one call and at the border points."""
    rng = np.random.default_rng(feat * 10 + dim)
    reso = (9, 12, 7, 5)[:dim]
    combos = tkpf.plane_combinations(dim)
    planes = [(c1, c2, reso[c2], reso[c1]) for c1, c2 in combos]
    tables = []
    for i, (_c1, _c2, h, w) in enumerate(planes):
        plane = torch.from_numpy(rng.uniform(0.1, 0.5, (h, w, feat))
                                 .astype(np.float32))
        # alternate layouts: unpacked [h*w, F] and quad-packed [h*w, 4F]
        tables.append(plane.reshape(h * w, feat).to(torch.bfloat16) if i % 2
                      else _quad(plane))
    pts = _points(rng, 333, dim)
    out = torch.full((333, feat), np.nan)
    got = tpk.kplanes_fwd_fused(_t(pts), tables, planes, out)
    assert got is out
    want = _old_route(pts, tables, planes, feat)
    assert torch.equal(got, want)


def test_fused_plain_writes_only_its_column_slice():
    """Into the [M, S*F] concatenated features, the wrapper writes its
    scale's F columns and leaves its neighbours as they were."""
    rng = np.random.default_rng(7)
    feat, m = 8, 100
    planes = [(0, 1, 6, 5), (0, 2, 4, 5), (1, 2, 4, 6)]
    tables = [_quad(torch.from_numpy(rng.uniform(0.1, 0.5, (h, w, feat))
                                        .astype(np.float32)))
              for _c1, _c2, h, w in planes]
    pts = _t(_points(rng, m, 3))
    buf = torch.full((m, 3 * feat), -7.0)
    tpk.kplanes_fwd_fused(pts, tables, planes, buf[:, feat:2 * feat])
    want = tpk.kplanes_fwd_fused(pts, tables, planes, torch.empty((m, feat)))
    assert torch.equal(buf[:, feat:2 * feat], want)
    assert bool((buf[:, :feat] == -7.0).all() and (buf[:, 2 * feat:] == -7.0).all())


def test_fused_order_is_jax_plane_order():
    """The staged branch multiplies the planes in _sampled_planes' order
    (XY, XZ, XT, YZ, YT, ZT), not grouped by y axis: bit-equal to the
    product of single-plane launches taken in that order."""
    rng = np.random.default_rng(8)
    grids = _grids(rng, (10, 12, 14, 6), (1,), 32)
    tgrids = [[_t(g) for g in gs] for gs in grids]
    staged = tkpf.pack_grids_for_render({"grids": tgrids})["grids_packed"]
    pts = _t(_points(rng, 200, 4))
    got = tkpf.interpolate_kplanes(pts, tgrids, concat_features=True,
                                   ms_packed=staged)
    acc = None
    for ci, (c1, c2) in tkpf._sampled_planes(4, 6):
        h, w = tgrids[0][ci].shape[:2]
        f = tpk.kplanes_fwd_fused(pts, [staged[0][ci]], [(c1, c2, h, w)],
                                  torch.empty((200, 32)))
        acc = f if acc is None else acc * f
    assert torch.equal(got, acc)
