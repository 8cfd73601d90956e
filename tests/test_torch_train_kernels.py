"""The port's backward plane kernels (plain versions, on the CPU) and its two
differentiable group samplers, against the JAX package: its Pallas backward
kernels in interpret mode, an f32 transpose oracle (``jax.vjp``), and
``jax.grad`` through its ``custom_vjp`` group samplers.

The CUDA kernels run only on the card (tests/test_torch_cuda_kernels.py and
chip_smoke.py hold them against these plain versions there); here the
wrappers take their plain versions because the tensors lie on the CPU.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from soccernerfs_tpu.fields import kplanes as jkpf
from soccernerfs_tpu.ops import grid_sample as jgs
from soccernerfs_tpu.ops.pallas import plane_kernels as jpk
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


def _sorted_points(rng, h, w, m, planes, feat):
    """Points as tests/test_pallas_plane_kernels.py makes them for the
    Pallas backward: row ids sorted by y, cells below the last row and
    column (the Pallas fold's halo bookkeeping), fractions in [0, 1)."""
    y = np.sort(rng.uniform(0, 1, m).astype(np.float32))
    yc = np.minimum((y * (h - 1)).astype(np.int32), h - 2)
    rowids, txs, gs = [], [], []
    for _ in range(planes):
        x = rng.uniform(0, 1, m).astype(np.float32)
        xc = np.minimum((x * (w - 1)).astype(np.int32), w - 2)
        rowids.append(yc * w + xc)
        txs.append(rng.uniform(0, 1, m).astype(np.float32))
        gs.append(rng.standard_normal((m, feat), dtype=np.float32))
    return gs, rowids, txs, rng.uniform(0, 1, m).astype(np.float32)


def _border_points(rng, h, w, m, planes, feat, sort=False):
    """Points from continuous coordinates through grid_coords, with exact
    right and bottom border cells (x0 = w-1 or y0 = h-1, fraction 0) and
    some out-of-range coordinates (clamped onto the border)."""
    yv = rng.uniform(-1.05, 1.05, m).astype(np.float32)
    yv[:7] = 1.0
    if sort:
        yv.sort()
    yc, ty = tgs.grid_coords(_t(yv), h)
    rowids, txs, gs = [], [], []
    for _ in range(planes):
        xv = rng.uniform(-1.05, 1.05, m).astype(np.float32)
        xv[3:11] = 1.0
        xc, tx = tgs.grid_coords(_t(xv), w)
        rowids.append((yc * w + xc).numpy())
        txs.append(tx.numpy())
        gs.append(rng.standard_normal((m, feat), dtype=np.float32))
    return gs, rowids, txs, ty.numpy()


def _rel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()
                 / (np.abs(np.asarray(want)).max() + 1e-12))


# the cases of tests/test_pallas_plane_kernels.py's fold test
FOLD_CASES = [
    (12, 16, 613, 2, 32, 3),     # multi-block: spill rows cross blocks
    (7, 8, 99, 1, 8, 2),         # tiny stripes, heavy borders
    (20, 24, 900, 3, 48, 2),     # 3-plane group
    (6, 16, 333, 1, 16, 1),      # tg < w+1: spill spans two blocks
]


@pytest.mark.parametrize("h,w,m,planes,tr,group", FOLD_CASES)
def test_bwd_unpacked_plain_matches_pallas_fold(h, w, m, planes, tr, group):
    """bilerp_bwd_unpacked (plain, through the wrapper) == the Pallas
    bilerp_bwd_group_fold in interpret mode.  Tolerance 1e-2 of the max
    magnitude: the TPU kernel rounds g and every weighted term to bf16."""
    rng = np.random.default_rng(41)
    gs, rowids, txs, ty = _sorted_points(rng, h, w, m, planes, 32)
    want = jpk.bilerp_bwd_group_fold(
        [jnp.asarray(g) for g in gs], [jnp.asarray(r) for r in rowids],
        [jnp.asarray(t) for t in txs], jnp.asarray(ty), h=h, w=w, tr=tr,
        group=group, interpret=True)
    got = tpk.bilerp_bwd_unpacked([_t(g) for g in gs], [_t(r) for r in rowids],
                                  [_t(t) for t in txs], _t(ty), h=h, w=w)
    for g, e in zip(got, want):
        assert g.shape == (h * w, 32)
        assert _rel(g.numpy(), e) <= 1e-2


@pytest.mark.parametrize("feat,r,m,planes,tr,group", [
    (32, 30 * 64, 513, 1, 128, 3),    # test_bwd_kernel_matches_scatter
    (32, 24 * 32, 700, 3, 96, 2),
    (8, 30 * 64, 1500, 2, 64, 2),     # row-packed lines (4F = 32)
    (8, 12 * 20, 400, 3, 16, 4),
])
def test_bwd_packed_plain_matches_pallas(feat, r, m, planes, tr, group):
    """bilerp_bwd_packed (plain) == the Pallas packed_bilerp_bwd_group in
    interpret mode, F = 32 and F = 8, sorted row ids; 1e-2 of the max for
    the TPU kernel's bf16 terms."""
    rng = np.random.default_rng(42)
    rowids = [np.sort(rng.integers(0, r, m).astype(np.int32))
              for _ in range(planes)]
    txs = [rng.uniform(0, 1, m).astype(np.float32) for _ in range(planes)]
    ty = rng.uniform(0, 1, m).astype(np.float32)
    gs = [rng.standard_normal((m, feat), dtype=np.float32) for _ in range(planes)]
    want = jpk.packed_bilerp_bwd_group(
        [jnp.asarray(g) for g in gs], [jnp.asarray(i) for i in rowids],
        [jnp.asarray(t) for t in txs], jnp.asarray(ty), r=r, tr=tr,
        group=group, interpret=True)
    got = tpk.bilerp_bwd_packed([_t(g) for g in gs], [_t(i) for i in rowids],
                                [_t(t) for t in txs], _t(ty), rows=r)
    for g, e in zip(got, want):
        assert g.shape == (r, 4 * feat)
        assert _rel(g.numpy(), e) <= 1e-2


def _jax_lerp_rows(table, rowid, tx, ty, feat):
    """f32 gather + lerp of quad-packed rows (no bf16 anywhere)."""
    rows = jnp.take(table, rowid, axis=0)
    txc, tyc = tx[:, None], ty[:, None]
    top = rows[:, :feat] * (1 - txc) + rows[:, feat:2 * feat] * txc
    bot = rows[:, 2 * feat:3 * feat] * (1 - txc) + rows[:, 3 * feat:] * txc
    return top * (1 - tyc) + bot * tyc


@pytest.mark.parametrize("feat", [8, 32])
@pytest.mark.parametrize("h,w,m,planes", [(9, 8, 700, 2), (1, 5, 60, 1),
                                          (13, 7, 900, 3), (2, 2, 400, 1)])
def test_bwd_plain_match_f32_transpose(h, w, m, planes, feat):
    """Both plain backward versions == jax.vjp of the f32 forward (a
    gather of quad_pack(grid) rows, and of the packed table itself), on
    unsorted points with exact right/bottom border cells, degenerate
    1-row and 2x2 planes included: 1e-5 of the max (the same sums in
    another order)."""
    rng = np.random.default_rng(43)
    gs, rowids, txs, ty = _border_points(rng, h, w, m, planes, feat)
    got_u = tpk.bilerp_bwd_unpacked([_t(g) for g in gs], [_t(r) for r in rowids],
                                    [_t(t) for t in txs], _t(ty), h=h, w=w)
    got_p = tpk.bilerp_bwd_packed([_t(g) for g in gs], [_t(r) for r in rowids],
                                  [_t(t) for t in txs], _t(ty), rows=h * w)
    for p in range(planes):
        args = (jnp.asarray(rowids[p]), jnp.asarray(txs[p]), jnp.asarray(ty), feat)
        grid = jnp.zeros((h, w, feat), jnp.float32)
        _, vjp = jax.vjp(lambda g: _jax_lerp_rows(jgs.quad_pack(g), *args), grid)
        (want_u,) = vjp(jnp.asarray(gs[p]))
        assert _rel(got_u[p].numpy().reshape(h, w, feat), want_u) <= 1e-5
        table = jnp.zeros((h * w, 4 * feat), jnp.float32)
        _, vjp = jax.vjp(lambda t: _jax_lerp_rows(t, *args), table)
        (want_p,) = vjp(jnp.asarray(gs[p]))
        assert _rel(got_p[p].numpy(), want_p) <= 1e-5


def test_heavy_collisions_plain_match_f32_transpose():
    """Many points on a 2x2 table (every add lands on four rows): the
    plain version against the numpy float64 transpose, 1e-5."""
    rng = np.random.default_rng(44)
    gs, rowids, txs, ty = _border_points(rng, 2, 2, 5000, 1, 32)
    (got,) = tpk.bilerp_bwd_unpacked([_t(gs[0])], [_t(rowids[0])], [_t(txs[0])],
                                     _t(ty), h=2, w=2)
    want = np.zeros((4, 32))
    y0, x0 = rowids[0] // 2, rowids[0] % 2
    x1, y1 = np.minimum(x0 + 1, 1), np.minimum(y0 + 1, 1)
    tx = txs[0].astype(np.float64)
    t = ty.astype(np.float64)
    g = gs[0].astype(np.float64)
    for yy, xx, wt in ((y0, x0, (1 - tx) * (1 - t)), (y0, x1, tx * (1 - t)),
                       (y1, x0, (1 - tx) * t), (y1, x1, tx * t)):
        np.add.at(want, yy * 2 + xx, g * wt[:, None])
    assert _rel(got.numpy(), want) <= 1e-5


def _sorted_group_inputs(rng, h, w, m, planes, feat):
    """Coordinates in [-1, 1] sorted by the shared y one (the JAX fold
    sampler needs stripe-sorted row ids) and f32 grids."""
    ycoord = np.sort(rng.uniform(-1, 1, m).astype(np.float32))
    xcoords = [rng.uniform(-1, 1, m).astype(np.float32) for _ in range(planes)]
    grids = [rng.uniform(0.1, 0.5, (h, w, feat)).astype(np.float32)
             for _ in range(planes)]
    cots = [rng.standard_normal((m, feat)).astype(np.float32)
            for _ in range(planes)]
    return ycoord, xcoords, grids, cots


def _port_rows(ycoord, xcoords, h, w):
    yc, ty = tgs.grid_coords(_t(ycoord), h)
    rowids, txs = [], []
    for x in xcoords:
        xc, tx = tgs.grid_coords(_t(x), w)
        rowids.append(yc * w + xc)
        txs.append(tx)
    return rowids, txs, ty


@pytest.mark.parametrize("h,w,m,planes", [(24, 16, 500, 2), (10, 8, 300, 3)])
def test_fold_group_grad_matches_jax(h, w, m, planes):
    """torch.autograd through the port's plane_sample_fold_group == jax.grad
    through the JAX one with its Pallas fold backward (interpret mode):
    features 1e-6 (the same bf16 gather and f32 lerp), grid gradients 1e-2
    of the max (the Pallas kernel's bf16 terms)."""
    rng = np.random.default_rng(45)
    ycoord, xcoords, grids, cots = _sorted_group_inputs(rng, h, w, m, planes, 32)
    jy, jty = jgs.grid_coords(jnp.asarray(ycoord), h)
    jrows, jtxs = [], []
    for x in xcoords:
        xc, tx = jgs.grid_coords(jnp.asarray(x), w)
        jrows.append(jy * w + xc)
        jtxs.append(tx)

    def jloss(gr):
        feats = jgs.plane_sample_fold_group(gr, jrows, jtxs, jty,
                                            use_pallas_bwd=True, interpret=True)
        return sum(jnp.vdot(f, jnp.asarray(c)) for f, c in zip(feats, cots)), feats

    (_, jfeats), jgrads = jax.value_and_grad(jloss, has_aux=True)(
        [jnp.asarray(g) for g in grids])
    tgrids = [_t(g).requires_grad_(True) for g in grids]
    rowids, txs, ty = _port_rows(ycoord, xcoords, h, w)
    feats = tgs.plane_sample_fold_group(tgrids, rowids, txs, ty)
    sum((f * _t(c)).sum() for f, c in zip(feats, cots)).backward()
    for f, jf in zip(feats, jfeats):
        np.testing.assert_allclose(f.detach().numpy(), np.asarray(jf), atol=1e-6)
    for g, jg in zip(tgrids, jgrads):
        assert _rel(g.grad.numpy(), jg) <= 1e-2


@pytest.mark.parametrize("h,w,m,planes", [(24, 16, 700, 2), (12, 8, 400, 3)])
def test_packed_group_grad_matches_jax(h, w, m, planes):
    """torch.autograd through quad_pack and the port's
    plane_sample_group_bwdsort (F = 8) == jax.grad through the JAX one with
    its sort and Pallas packed backward (interpret mode): features 1e-6,
    grid gradients (the quad_pack transpose included) 1e-2 of the max."""
    rng = np.random.default_rng(46)
    ycoord = rng.uniform(-1, 1, m).astype(np.float32)      # unsorted
    xcoords = [rng.uniform(-1, 1, m).astype(np.float32) for _ in range(planes)]
    grids = [rng.uniform(0.1, 0.5, (h, w, 8)).astype(np.float32)
             for _ in range(planes)]
    cots = [rng.standard_normal((m, 8)).astype(np.float32) for _ in range(planes)]

    def jloss(gr):
        feats = jgs.plane_sample_group_bwdsort(
            [jgs.quad_pack(g) for g in gr], [jnp.asarray(x) for x in xcoords],
            jnp.asarray(ycoord), h=h, w=w, use_pallas_bwd=True, interpret=True)
        return sum(jnp.vdot(f, jnp.asarray(c)) for f, c in zip(feats, cots)), feats

    (_, jfeats), jgrads = jax.value_and_grad(jloss, has_aux=True)(
        [jnp.asarray(g) for g in grids])
    tgrids = [_t(g).requires_grad_(True) for g in grids]
    rowids, txs, ty = _port_rows(ycoord, xcoords, h, w)
    feats = tgs.plane_sample_group_bwdsort([tgs.quad_pack(g) for g in tgrids],
                                           rowids, txs, ty)
    sum((f * _t(c)).sum() for f, c in zip(feats, cots)).backward()
    for f, jf in zip(feats, jfeats):
        np.testing.assert_allclose(f.detach().numpy(), np.asarray(jf), atol=1e-6)
    for g, jg in zip(tgrids, jgrads):
        assert _rel(g.grad.numpy(), jg) <= 1e-2


@pytest.mark.parametrize("feat,freeze", [
    (32, None), (32, "space"), (32, "time"), (8, None), (8, "space")])
def test_interpolate_kplanes_grads_match_jax(feat, freeze):
    """The field's differentiable branch (F = 32 through
    plane_sample_fold_group, F = 8 with widths divisible by 4 through
    quad_pack and plane_sample_group_bwdsort; the product out of place)
    == JAX's interpolate_kplanes on the CPU, values and grid gradients,
    with freeze_space_planes (space planes detached: no gradient) and
    freeze_time_planes (time planes skipped).  Values 1e-5 of the max (the
    same bf16 gathers, products in another order); gradients 2e-2 of each
    grid's max: JAX's CPU transpose adds bf16 cotangents."""
    rng = np.random.default_rng(48)
    reso = [(8, 12, 8, 5), (16, 24, 16, 5)]
    grids = [[rng.uniform(0.1, 0.5, (r[c2], r[c1], feat)).astype(np.float32)
              for c1, c2 in tkpf.plane_combinations(4)] for r in reso]
    pts = rng.uniform(-1.05, 1.05, (600, 4)).astype(np.float32)
    kw = dict(concat_features=feat == 32,
              freeze_space_planes=freeze == "space",
              freeze_time_planes=freeze == "time")
    cot = rng.standard_normal((600, feat * (2 if feat == 32 else 1))).astype(np.float32)

    def jfn(gs):
        out = jkpf.interpolate_kplanes(jnp.asarray(pts), gs, **kw)
        return jnp.vdot(out, jnp.asarray(cot)), out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(jfn, has_aux=True))(
        [[jnp.asarray(g) for g in gs] for gs in grids])
    tgrids = [[_t(g).requires_grad_(True) for g in gs] for gs in grids]
    out = tkpf.interpolate_kplanes(_t(pts), tgrids, **kw)
    (out * _t(cot)).sum().backward()
    assert _rel(out.detach().numpy(), jout) <= 1e-5
    for ts, js in zip(tgrids, jgrads):
        for ci, (t, j) in enumerate(zip(ts, js)):
            time_plane = ci in (2, 4, 5)
            if (freeze == "space" and not time_plane) or (freeze == "time" and time_plane):
                assert t.grad is None and np.abs(np.asarray(j)).max() == 0.0
            else:
                assert _rel(t.grad.numpy(), j) <= 2e-2, ci
    with pytest.raises(ValueError, match="require grad"):
        tkpf.interpolate_kplanes(_t(pts).requires_grad_(True), tgrids, **kw)


def test_group_samplers_give_coordinates_no_gradient():
    """Only the grids (tables) get gradients; a frozen grid gets none and
    the backward skips it."""
    rng = np.random.default_rng(47)
    ycoord, xcoords, grids, cots = _sorted_group_inputs(rng, 6, 8, 50, 2, 32)
    rowids, txs, ty = _port_rows(ycoord, xcoords, 6, 8)
    g0 = _t(grids[0]).requires_grad_(True)
    feats = tgs.plane_sample_fold_group([g0, _t(grids[1])], rowids, txs, ty)
    (feats[0].sum() + feats[1].sum()).backward()
    assert g0.grad is not None and g0.grad.shape == (6, 8, 32)
    assert not txs[0].requires_grad and not ty.requires_grad


def test_backward_wrappers_take_plain_versions_on_cpu():
    """On CPU tensors the backward wrappers take their plain versions and
    count no launch; the returned tables are f32 and zero where no point
    lands."""
    tpk.reset_launch_counts()
    g = torch.ones((3, 8))
    z = torch.zeros(3, dtype=torch.int32)
    f = torch.zeros(3)
    (u,) = tpk.bilerp_bwd_unpacked([g], [z], [f], f, h=2, w=3)
    (p,) = tpk.bilerp_bwd_packed([g], [z], [f], f, rows=6)
    assert u.dtype == p.dtype == torch.float32
    assert float(u[0].sum()) == 24.0 and float(u[1:].abs().sum()) == 0.0
    assert float(p[0, :8].sum()) == 24.0 and float(p[0, 8:].abs().sum()) == 0.0
    assert tpk.bilerp_bwd_unpacked.launches == 0
    assert tpk.bilerp_bwd_packed.launches == 0
