"""The plane samplers' coordinate backward (the camera optimizer's K-Planes
path) against the JAX package on the CPU: ``grid_coords``' gradient,
``bilerp_bwd_coords``' plain version against ``jax.grad`` of
``sample_plane_bilinear_packed``, the wrapper's card route with its
launch replaced by the plain version (``fake_card``), the group samplers'
routing (a coordinate launch only when the fractions need a gradient) and
``interpolate_kplanes``' position gradient.

The JAX package computes these gradients with XLA's autodiff of its gather
and lerp; the port computes them with one ``bilerp_bwd_coords`` launch per
plane group (tests/test_torch_cuda_kernels.py holds the kernel itself
against its plain version on the card).  Inputs are made with numpy from a
seed; every tolerance is stated with its reason.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from soccernerfs_tpu.fields import kplanes as jkpf
from soccernerfs_tpu.ops import grid_sample as jgs
from soccernerfs_tpu_torch.fields import kplanes as tkpf
from soccernerfs_tpu_torch.ops import grid_sample as tgs
from soccernerfs_tpu_torch.ops.kernels import plane_kernels as pk


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch CPU thread while this file runs (the suite runs in
    parallel worker processes, whose default thread pools oversubscribe
    the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rel(got, want) -> float:
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


def _coords(rng, m):
    """[m] coordinates in [-1.3, 1.3]: random, the bounds exactly, points
    outside the plane on both sides."""
    c = rng.uniform(-1.0, 1.0, m).astype(np.float32)
    c[:4] = [-1.0, 1.0, -1.3, 1.25]
    return c


# ---------------------------------------------------------------------------
# grid_coords
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", [1, 2, 7, 64, 300])
def test_grid_coords_gradient_matches_jax(size):
    """The fraction's gradient with respect to the coordinate, against
    jax.grad of the JAX package's grid_coords: exact, at the bounds (0.5,
    jnp.clip's tie rule, where torch.clamp would give 1), inside (the
    scale 0.5 (size - 1)) and outside the plane (0).  The cells and
    fractions are the JAX ones too."""
    rng = np.random.default_rng(size)
    c = _coords(rng, 200)
    cot = rng.standard_normal(200).astype(np.float32)
    jcell, jfrac = jgs.grid_coords(jnp.asarray(c), size)
    jgrad = jax.grad(lambda x: jnp.vdot(jgs.grid_coords(x, size)[1], cot))(
        jnp.asarray(c))
    x = _t(c).requires_grad_(True)
    cell, frac = pk.grid_coords(x, size)
    frac.backward(_t(cot))
    assert np.array_equal(_np(cell), np.asarray(jcell))
    assert np.array_equal(_np(frac), np.asarray(jfrac))
    assert np.array_equal(_np(x.grad), np.asarray(jgrad))
    scale = np.float32(0.5 * (size - 1))
    assert _np(x.grad)[0] == 0.5 * cot[0] * scale
    assert _np(x.grad)[2] == 0.0 and _np(x.grad)[3] == 0.0
    assert tgs.grid_coords is pk.grid_coords


# ---------------------------------------------------------------------------
# the plain version against JAX's autodiff
# ---------------------------------------------------------------------------

def _unpacked(plane):
    """The unpacked staged table of an [H, W, F] plane, padded as
    stage_table pads it."""
    h, w, f = plane.shape
    wide = pk.native_feat(f)
    padded = torch.nn.functional.pad(plane, (0, wide - f))
    return padded.reshape(h * w, wide).to(torch.bfloat16).contiguous()


def _packed(plane):
    h, w, f = plane.shape
    padded = torch.nn.functional.pad(plane, (0, pk.native_feat(f) - f))
    return tgs.quad_pack(padded.to(torch.bfloat16)).contiguous()


def _coord_grads_from_plain(table, plane_shape, coords, g):
    """d <sample, g> / d coords [M, 2] through grid_coords' gradient and
    bilerp_bwd_coords_plain's fractions' gradients."""
    h, w, _f = plane_shape
    cx = coords[:, 0].clone().requires_grad_(True)
    cy = coords[:, 1].clone().requires_grad_(True)
    xc, tx = pk.grid_coords(cx, w)
    yc, ty = pk.grid_coords(cy, h)
    (d_tx,), d_ty = pk.bilerp_bwd_coords_plain(
        [table], [g], [yc * w + xc], [tx.detach()], ty.detach(), h=h, w=w)
    gx, = torch.autograd.grad(tx, cx, d_tx)
    gy, = torch.autograd.grad(ty, cy, d_ty)
    return torch.stack([gx, gy], -1)


@pytest.mark.parametrize("layout", ["unpacked", "packed"])
@pytest.mark.parametrize("feat", [8, 20, 24, 32])
def test_plain_coords_bwd_matches_jax_autodiff(layout, feat):
    """bilerp_bwd_coords_plain on a staged table of either layout (the
    same bf16 values) against jax.grad of sample_plane_bilinear_packed
    (bf16 quad-packed gather, f32 lerp) with respect to its coordinates:
    1e-5 of the max (the same f32 corner differences, summed over F in
    another order); points on the last row and column (whose gradient
    across the border is 0), at the bounds and outside the plane."""
    rng = np.random.default_rng(feat)
    h, w, m = 9, 13, 500
    plane = rng.uniform(-1, 1, (h, w, feat)).astype(np.float32)
    coords = np.stack([_coords(rng, m), _coords(rng, m)[::-1].copy()], -1)
    coords[10:20, 0] = 1.0
    coords[20:30, 1] = 1.0
    g = rng.standard_normal((m, feat)).astype(np.float32)
    want = jax.grad(lambda c: jnp.vdot(jgs.sample_plane_bilinear_packed(
        jnp.asarray(plane), c), g))(jnp.asarray(coords))
    tplane = _t(plane)
    table = _unpacked(tplane) if layout == "unpacked" else _packed(tplane)
    got = _coord_grads_from_plain(table, plane.shape, _t(coords), _t(g))
    assert float(np.abs(np.asarray(want)).max()) > 0
    assert _rel(got, want) <= 1e-5, _rel(got, want)
    # across the last column the fraction's gradient is 0 (its two corners
    # are one value): only the y gradient is left there
    at_right = coords[:, 0] >= 1.0
    assert not _np(got)[at_right & (np.abs(coords[:, 0]) <= 1.0), 0].any()


def test_plain_coords_bwd_sums_the_planes_into_ty():
    """Three planes of one group: each d_tx is its own plane's, and d_ty
    is the sum over the planes of each plane's alone (up to f32 rounding
    of that sum)."""
    rng = np.random.default_rng(3)
    h, w, m, feat = 6, 10, 300, 32
    tables = [_packed(_t(rng.uniform(-1, 1, (h, w, feat)).astype(np.float32)))
              for _ in range(3)]
    gs = [_t(rng.standard_normal((m, feat)).astype(np.float32)) for _ in range(3)]
    ty = _t(rng.uniform(0, 1, m).astype(np.float32))
    rowids = [_t(rng.integers(0, h * w, m).astype(np.int32)) for _ in range(3)]
    txs = [_t(rng.uniform(0, 1, m).astype(np.float32)) for _ in range(3)]
    d_txs, d_ty = pk.bilerp_bwd_coords_plain(tables, gs, rowids, txs, ty,
                                             h=h, w=w)
    alone = [pk.bilerp_bwd_coords_plain([t], [g], [r], [x], ty, h=h, w=w)
             for t, g, r, x in zip(tables, gs, rowids, txs)]
    for d, (a, _) in zip(d_txs, alone):
        assert torch.equal(d, a[0])
    assert _rel(d_ty, sum(a[1] for a in alone)) <= 1e-6


# ---------------------------------------------------------------------------
# the wrapper's card route
# ---------------------------------------------------------------------------

@pytest.fixture
def fake_card(monkeypatch):
    """The wrappers' card route on CPU tensors: the operand checks run
    (all but the device's), and each coordinate launch runs the plain
    version at the launched width, which must be a compiled one.  Yields
    the launches' (width, packed) pairs."""
    launched = []

    def launch(tables, gs, rowids, txs, ty, d_txs, d_ty, m, packed, h, w, feat):
        assert feat in pk.FEATS and gs[0].shape[1] == feat
        assert tables[0].shape[1] == (4 * feat if packed else feat)
        launched.append((feat, packed))
        res_tx, res_ty = pk.bilerp_bwd_coords_plain(tables, gs, rowids, txs,
                                                    ty, h=h, w=w)
        for o, r in zip(d_txs, res_tx):
            o.copy_(r)
        d_ty.copy_(res_ty)

    monkeypatch.setattr(pk, "_on_cpu", lambda tensors: False)
    monkeypatch.setattr(pk, "_require_cuda", lambda dev: None)
    monkeypatch.setattr(pk, "_launch_coords", launch)
    yield launched


@pytest.mark.parametrize("feat,layout", [(8, "packed"), (32, "unpacked"),
                                         (20, "packed"), (24, "unpacked")])
def test_wrapper_routes_and_counts(fake_card, feat, layout):
    """The wrapper pads g to the compiled width, launches once with the
    layout its tables have, counts the launch under the width asked for,
    and returns what the plain version returns."""
    rng = np.random.default_rng(feat + 1)
    h, w, m = 7, 12, 200
    planes = [_t(rng.uniform(-1, 1, (h, w, feat)).astype(np.float32))
              for _ in range(2)]
    tables = [(_unpacked if layout == "unpacked" else _packed)(p) for p in planes]
    gs = [_t(rng.standard_normal((m, feat)).astype(np.float32)) for _ in planes]
    rowids = [_t(rng.integers(0, h * w, m).astype(np.int32)) for _ in planes]
    txs = [_t(rng.uniform(0, 1, m).astype(np.float32)) for _ in planes]
    ty = _t(rng.uniform(0, 1, m).astype(np.float32))
    before = pk.bilerp_bwd_coords.launches
    by_width = dict(pk.bilerp_bwd_coords.launches_by_width)
    d_txs, d_ty = pk.bilerp_bwd_coords(tables, gs, rowids, txs, ty, h=h, w=w)
    assert fake_card == [(pk.native_feat(feat), int(layout == "packed"))]
    assert pk.bilerp_bwd_coords.launches == before + 1
    assert pk.bilerp_bwd_coords.launches_by_width[feat] == by_width.get(feat, 0) + 1
    want_tx, want_ty = pk.bilerp_bwd_coords_plain(tables, gs, rowids, txs, ty,
                                                  h=h, w=w)
    for got, want in zip(d_txs, want_tx):
        assert torch.equal(got, want)
    assert torch.equal(d_ty, want_ty)


def test_wrapper_refuses_what_the_kernel_does_not_take(fake_card):
    """The operand checks of the other backward wrappers, and a table that
    is neither layout of g's width."""
    z = torch.zeros(4, dtype=torch.int32)
    f = torch.zeros(4)
    g = torch.zeros((4, 8))
    table = torch.zeros((12, 32), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bfloat16"):
        pk.bilerp_bwd_coords([table.float()], [g], [z], [f], f, h=3, w=4)
    with pytest.raises(ValueError, match="neither"):
        pk.bilerp_bwd_coords([torch.zeros((12, 16), dtype=torch.bfloat16)],
                             [g], [z], [f], f, h=3, w=4)
    with pytest.raises(ValueError, match="neither"):
        pk.bilerp_bwd_coords([table], [g], [z], [f], f, h=2, w=4)
    with pytest.raises(ValueError, match="planes per launch"):
        pk.bilerp_bwd_coords([table] * 4, [g] * 4, [z] * 4, [f] * 4, f, h=3, w=4)
    with pytest.raises(ValueError, match="feature width"):
        pk.bilerp_bwd_coords([torch.zeros((12, 4 * 136), dtype=torch.bfloat16)],
                             [torch.zeros((4, 136))], [z], [f], f, h=3, w=4)
    assert fake_card == []


def test_wrappers_refuse_tables_of_2_31_rows(fake_card):
    """The unpacked forward and the coordinate backward form cells in 32
    bits: their wrappers refuse a table of h*w >= 2**31 rows before
    anything else, and take h*w = 2**31 - 1 as far as their other checks
    (here: the table's row count)."""
    z = torch.zeros(4, dtype=torch.int32)
    f = torch.zeros(4)
    table = torch.zeros((12, 8), dtype=torch.bfloat16)
    g = torch.zeros((4, 8))
    for h, w in ((2 ** 16, 2 ** 15), (2 ** 31, 1), (3, 2 ** 30 + 1)):
        with pytest.raises(ValueError, match=r"below 2\*\*31"):
            pk.bilerp_fwd_unpacked([table], [z], [f], f, h=h, w=w)
        with pytest.raises(ValueError, match=r"below 2\*\*31"):
            pk.bilerp_bwd_coords([table], [g], [z], [f], f, h=h, w=w)
    with pytest.raises(ValueError, match="table has 12 rows"):
        pk.bilerp_fwd_unpacked([table], [z], [f], f, h=2 ** 31 - 1, w=1)
    with pytest.raises(ValueError, match="neither"):
        pk.bilerp_bwd_coords([table], [g], [z], [f], f, h=1, w=2 ** 31 - 1)
    assert fake_card == []


def test_packed_forward_refuses_tables_of_2_31_rows(fake_card):
    """The packed forward clips and offsets its rows in 32 bits: its
    wrapper refuses a table of 2**31 rows or more before anything else
    (meta tensors: no memory), and takes 2**31 - 1 rows as far as its
    other checks (here: the operands' devices)."""
    before = pk.bilerp_fwd_packed.launches
    meta = {"dtype": torch.bfloat16, "device": "meta"}
    f = torch.zeros(4)
    z = torch.zeros(4, dtype=torch.int32)
    for rows in (2 ** 31, 2 ** 32 + 5):
        with pytest.raises(ValueError, match=r"below 2\*\*31"):
            pk.bilerp_fwd_packed([torch.empty((rows, 32), **meta)], [z], [f], f)
    with pytest.raises(ValueError, match="per-point operands"):
        pk.bilerp_fwd_packed([torch.empty((2 ** 31 - 1, 32), **meta)], [z],
                             [f], f)
    assert pk.bilerp_fwd_packed.launches == before


@pytest.mark.parametrize("w", [1, 2, 3, 7, 32, 100, 256, 1023, 1024, 1025,
                               2048, 32767, 65535, 2 ** 20 + 1, 2 ** 30,
                               2 ** 30 + 1, 2 ** 31 - 1])
def test_row_divisor_is_exact(w):
    """``row_divisor(w)``'s (magic, shift), the constants the kernels form
    a point's cell with, give row // w exactly: on every row of the first
    and last 4w rows (at most 2**16 each) of the largest table of width w
    below 2**31 rows and of a 64-row one, around each of the last 64
    multiples of w, and on 200,000 seeded rows below 2**31."""
    magic, shift = pk.row_divisor(w)
    assert 0 < magic < 2 ** 32
    rows = pk.MAX_ROWS // w * w
    edge = min(4 * w, 2 ** 16)
    last = np.arange(max(rows // w - 64, 0), rows // w + 1, dtype=np.uint64) * w
    rng = np.random.default_rng(w)
    r = np.concatenate([
        np.arange(min(edge, rows), dtype=np.uint64),
        np.arange(rows - min(edge, rows), rows, dtype=np.uint64),
        np.arange(min(64 * w, 2 ** 16), dtype=np.uint64),
        *[np.clip(last.astype(np.int64) + d, 0, pk.MAX_ROWS).astype(np.uint64)
          for d in (-1, 0, 1)],
        np.array([pk.MAX_ROWS - 1, pk.MAX_ROWS], dtype=np.uint64),
        rng.integers(0, 2 ** 31, 200_000).astype(np.uint64),
    ])
    assert np.array_equal((r * np.uint64(magic)) >> np.uint64(shift),
                          r // np.uint64(w))


# ---------------------------------------------------------------------------
# the group samplers and the field
# ---------------------------------------------------------------------------

def _group_operands(rng, h, w, m, n, feat):
    grids = [_t(rng.uniform(0.1, 0.5, (h, w, feat)).astype(np.float32))
             .requires_grad_(True) for _ in range(n)]
    pts = _t(rng.uniform(-1, 1, (m, n + 1)).astype(np.float32))
    return grids, pts


def _group_sample(route, grids, pts, h, w):
    yc, ty = pk.grid_coords(pts[:, -1], h)
    rowids, txs = [], []
    for i in range(len(grids)):
        xc, tx = pk.grid_coords(pts[:, i], w)
        rowids.append(yc * w + xc)
        txs.append(tx)
    if route == "fold":
        return tgs.plane_sample_fold_group(grids, rowids, txs, ty)
    return tgs.plane_sample_group_bwdsort([tgs.quad_pack(g) for g in grids],
                                          rowids, txs, ty)


@pytest.mark.parametrize("route,feat,h,w", [
    ("fold", 32, 256, 256),   # staged unpacked (the field's big planes)
    ("fold", 32, 8, 12),      # a small plane, staged unpacked as every fold table
    ("fold", 20, 8, 12),      # padded to 24
    ("packed", 8, 8, 12),     # the proposal fields' route
])
def test_group_samplers_launch_the_coordinate_kernel_only_when_asked(
        fake_card, monkeypatch, route, feat, h, w):
    """Without a coordinate gradient a group's backward launches no
    coordinate kernel, its outputs and table gradients are those of the
    same call with one, bit for bit; with it, one launch per group over
    the tables the forward staged (either layout), and the coordinates'
    gradient is the one the plain version gives through grid_coords."""
    rng = np.random.default_rng(feat + h)
    m, n = 300, 3
    packed = int(route == "packed"
                 or tgs.stage_table(torch.zeros((h, w, feat))).shape[1]
                 != pk.native_feat(feat))
    grids, pts = _group_operands(rng, h, w, m, n, feat)
    g = [_t(rng.standard_normal((m, feat)).astype(np.float32)) for _ in range(n)]
    # the table kernels' card route: their plain versions
    monkeypatch.setattr(pk, "_launch", lambda name, ins, rowids, txs, ty, outs,
                        m, f, *shape: [o.copy_(r) for o, r in zip(outs, {
                            "snt_bilerp_fwd_unpacked": lambda: pk.bilerp_fwd_unpacked_plain(
                                ins, rowids, txs, ty, h=shape[0], w=shape[1]),
                            "snt_bilerp_fwd_packed": lambda: pk.bilerp_fwd_packed_plain(
                                ins, rowids, txs, ty),
                            "snt_bilerp_bwd_unpacked": lambda: pk.bilerp_bwd_unpacked_plain(
                                ins, rowids, txs, ty, h=shape[0], w=shape[1]),
                            "snt_bilerp_bwd_packed": lambda: pk.bilerp_bwd_packed_plain(
                                ins, rowids, txs, ty, rows=shape[0]),
                        }[name]())])
    outs, grads = [], []
    for needs in (False, True):
        p = pts.clone().requires_grad_(needs)
        feats = _group_sample(route, grids, p, h, w)
        loss = sum((f * gi).sum() for f, gi in zip(feats, g))
        leaves = [*grids, p] if needs else grids
        outs.append([f.detach() for f in feats])
        grads.append(torch.autograd.grad(loss, leaves))
        assert fake_card == ([(pk.native_feat(feat), packed)] if needs else [])
    for a, b in zip(outs[0], outs[1]):
        assert torch.equal(a, b)
    for a, b in zip(grads[0], grads[1][:n]):
        assert torch.equal(a, b)
    d_pts = grads[1][n]
    assert float(d_pts.abs().max()) > 0
    # the same through the plain version on the CPU route
    monkeypatch.undo()
    p = pts.clone().requires_grad_(True)
    feats = _group_sample(route, grids, p, h, w)
    want, = torch.autograd.grad(sum((f * gi).sum() for f, gi in zip(feats, g)), p)
    assert torch.equal(d_pts, want)


@pytest.mark.parametrize("dim,feat", [(3, 32), (4, 32), (4, 8), (4, 24)])
def test_interpolate_kplanes_position_gradient_matches_jax(dim, feat):
    """interpolate_kplanes' gradient with respect to its points, two scales
    (concatenated) of 3D or 4D planes, against jax.grad of the JAX
    package's XLA path (sorted_ok=False: the camera optimizer's), and the
    planes' gradients beside it: the points within 1e-4 of the max (each
    point's gradient is a product of planes' samples times the fractions'
    gradients, bf16 corners in both; f32 products and sums over F in
    another order), the planes within 2e-2 (JAX's transpose adds bf16
    cotangents, tests/test_torch_train_step.py)."""
    rng = np.random.default_rng(dim * 100 + feat)
    reso = [6, 8, 7, 5][:dim]
    ms = []
    for mult in (1, 2):
        scale = []
        for c1, c2 in tkpf.plane_combinations(dim):
            r = [x * mult if i < 3 else x for i, x in enumerate(reso)]
            scale.append(rng.uniform(0.2, 1.2, (r[c2], r[c1], feat)).astype(np.float32))
        ms.append(scale)
    m = 400
    pts = rng.uniform(-1, 1, (m, dim)).astype(np.float32)
    pts[:5] = 1.0
    pts[5:10] = -1.0
    cot = rng.standard_normal((m, 2 * feat)).astype(np.float32)

    def jloss(p, grids):
        return jnp.vdot(jkpf.interpolate_kplanes(p, grids, True, sorted_ok=False),
                        cot)

    jgp, jgg = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        jnp.asarray(pts), jax.tree_util.tree_map(jnp.asarray, ms))
    tgrids = [[_t(g).requires_grad_(True) for g in scale] for scale in ms]
    p = _t(pts).requires_grad_(True)
    out = tkpf.interpolate_kplanes(p, tgrids, True)
    leaves = [p, *[g for scale in tgrids for g in scale]]
    grads = torch.autograd.grad((out * _t(cot)).sum(), leaves)
    assert _rel(grads[0], jgp) <= 1e-4, _rel(grads[0], jgp)
    for got, want in zip(grads[1:], jax.tree_util.tree_leaves(jgg)):
        assert _rel(got, want) <= 2e-2
