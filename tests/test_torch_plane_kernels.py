"""The port's plane-sampling kernels (plain versions, on the CPU) against the
JAX package's Pallas kernels in interpret mode and its XLA gather.

The CUDA kernels themselves run only on the card (tests/test_torch_cuda_kernels.py
and chip_smoke.py hold them against these plain versions there); here the
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


def _bf16_table(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).to(torch.bfloat16)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _border_points(rng, h, w, m, planes):
    """Row ids (sorted in y), x fractions and a shared y fraction, with
    exact right/bottom border cells (x0 = w-1 or y0 = h-1, fraction 0)."""
    y = np.sort(rng.uniform(0, h - 1, m).astype(np.float32))
    y[:3] = h - 1
    y.sort()
    yc = y.astype(np.int32)
    ty = (y - yc).astype(np.float32)
    rowids, txs = [], []
    for _ in range(planes):
        x = rng.uniform(0, w - 1, m).astype(np.float32)
        x[:5] = w - 1
        xc = x.astype(np.int32)
        rowids.append(yc * w + xc)
        txs.append((x - xc).astype(np.float32))
    return rowids, txs, ty


# the cases of tests/test_pallas_plane_kernels.py's unpacked forward test
UNPACKED_CASES = [
    (25, 16, 700, 2, 32, 3),     # non-pow2 h, multi-block, boundary merges
    (9, 8, 99, 1, 8, 2),         # tiny stripes, heavy borders
    (20, 12, 900, 3, 24, 2),     # non-pow2 w, 3-plane group
    (100, 16, 555, 1, 64, 1),    # time-plane aspect
]


@pytest.mark.parametrize("h,w,m,planes,tr,group", UNPACKED_CASES)
def test_unpacked_plain_matches_pallas_interpret(h, w, m, planes, tr, group):
    """bilerp_fwd_unpacked (plain, through the wrapper) == the Pallas
    unpacked kernel.  Tolerance 1e-2 of the max magnitude: the bound the
    JAX tests hold that one-hot MXU kernel to."""
    rng = np.random.default_rng(31)
    r = h * w
    grids = [rng.standard_normal((h, w, 32), dtype=np.float32)
             for _ in range(planes)]
    rowids, txs, ty = _border_points(rng, h, w, m, planes)
    want = jpk.unpacked_bilerp_fwd_group(
        [jnp.asarray(g.reshape(r, 32)) for g in grids],
        [jnp.asarray(i) for i in rowids], [jnp.asarray(t) for t in txs],
        jnp.asarray(ty), h=h, w=w, tr=tr, group=group, interpret=True,
    )
    got = tpk.bilerp_fwd_unpacked(
        [_bf16_table(g.reshape(r, 32)) for g in grids],
        [_t(i) for i in rowids], [_t(t) for t in txs], _t(ty), h=h, w=w,
    )
    for g, e in zip(got, want):
        e = np.asarray(e)
        scale = np.abs(e).max()
        np.testing.assert_allclose(g.numpy() / scale, e / scale, atol=1e-2)


@pytest.mark.parametrize("h,w,m,planes,tr,group", UNPACKED_CASES)
def test_unpacked_plain_matches_xla_gather(h, w, m, planes, tr, group):
    """bilerp_fwd_unpacked (plain) == JAX's _bilerp_rows through the
    quad-packed bf16 table: the same arithmetic, so 1e-6 absolute."""
    rng = np.random.default_rng(32)
    r = h * w
    grids = [rng.standard_normal((h, w, 32), dtype=np.float32)
             for _ in range(planes)]
    rowids, txs, ty = _border_points(rng, h, w, m, planes)
    got = tpk.bilerp_fwd_unpacked(
        [_bf16_table(g.reshape(r, 32)) for g in grids],
        [_t(i) for i in rowids], [_t(t) for t in txs], _t(ty), h=h, w=w,
    )
    for g, grid, idx, tx in zip(got, grids, rowids, txs):
        want = jgs._bilerp_rows(jgs.quad_pack(jnp.asarray(grid)),
                                jnp.asarray(idx), jnp.asarray(tx),
                                jnp.asarray(ty), 32)
        np.testing.assert_allclose(g.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("r,m,planes,tr,group", [
    (24 * 32, 600, 2, 96, 2),    # multi-plane group (test_fwd_group_kernel_exact)
    (40 * 50, 777, 1, 256, 2),   # single plane (test_fwd_kernel_exact)
])
def test_packed_plain_matches_pallas_interpret(r, m, planes, tr, group):
    """bilerp_fwd_packed (plain) == the Pallas packed kernel at 1e-2 of the
    max magnitude (the JAX tests' bound for the one-hot kernel)."""
    rng = np.random.default_rng(9)
    tables = [rng.standard_normal((r, 128), dtype=np.float32)
              for _ in range(planes)]
    order = np.sort(rng.integers(0, r, m).astype(np.int32))
    rowids = [order, np.clip(order + 1, 0, r - 1)][:planes]
    txs = [rng.uniform(0, 1, m).astype(np.float32) for _ in range(planes)]
    ty = rng.uniform(0, 1, m).astype(np.float32)
    want = jpk.packed_bilerp_fwd_group(
        [jnp.asarray(t) for t in tables], [jnp.asarray(i) for i in rowids],
        [jnp.asarray(t) for t in txs], jnp.asarray(ty), tr=tr, group=group,
        interpret=True,
    )
    got = tpk.bilerp_fwd_packed(
        [_bf16_table(t) for t in tables], [_t(i) for i in rowids],
        [_t(t) for t in txs], _t(ty),
    )
    for g, e in zip(got, want):
        e = np.asarray(e)
        scale = np.abs(e).max()
        np.testing.assert_allclose(g.numpy() / scale, e / scale, atol=1e-2)


@pytest.mark.parametrize("feat", [8, 32])
def test_packed_plain_matches_xla_gather(feat):
    """bilerp_fwd_packed (plain) == JAX's _bilerp_rows at 1e-6 for both
    widths the render path stages (F = 8 proposal tables, whose 32-lane
    rows the Pallas kernel does not take, and F = 32), unsorted."""
    rng = np.random.default_rng(10)
    h, w, m = 13, 20, 500
    grid = rng.standard_normal((h, w, feat), dtype=np.float32)
    table = jgs.quad_pack(jnp.asarray(grid))
    pts = rng.uniform(-1.1, 1.1, (m, 2)).astype(np.float32)
    pts[:4] = [[1, 1], [-1, -1], [1, -1], [-1, 1]]
    xc, tx = jgs.grid_coords(jnp.asarray(pts[:, 0]), w)
    yc, ty = jgs.grid_coords(jnp.asarray(pts[:, 1]), h)
    idx = yc * w + xc
    want = jgs._bilerp_rows(table, idx, tx, ty, feat)
    (got,) = tpk.bilerp_fwd_packed(
        [_bf16_table(np.asarray(table))], [_t(idx)], [_t(tx)], _t(ty)
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_grid_coords_and_quad_pack_match_jax():
    """Border semantics: the coordinate clamps before the floor (x = w-1 ->
    cell w-1, fraction 0) and quad_pack replicates the right/bottom edge."""
    rng = np.random.default_rng(11)
    c = np.concatenate([rng.uniform(-1.2, 1.2, 200), [-1.0, 1.0, 0.0]]
                       ).astype(np.float32)
    for size in (2, 7, 64, 100):
        jc, jf = jgs.grid_coords(jnp.asarray(c), size)
        tc, tf = tgs.grid_coords(_t(c), size)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    plane = rng.standard_normal((5, 6, 4), dtype=np.float32)
    np.testing.assert_array_equal(tgs.quad_pack(_t(plane)).numpy(),
                                  np.asarray(jgs.quad_pack(jnp.asarray(plane))))


@pytest.mark.parametrize("packed", [False, True])
def test_sample_plane_bilinear_matches_jax(packed):
    """The plain samplers (f32 unpacked; bf16 quad-packed) == JAX's."""
    rng = np.random.default_rng(12)
    plane = rng.standard_normal((9, 14, 8), dtype=np.float32)
    coords = rng.uniform(-1.05, 1.05, (3, 40, 2)).astype(np.float32)
    jf = jgs.sample_plane_bilinear_packed if packed else jgs.sample_plane_bilinear
    tf = tgs.sample_plane_bilinear_packed if packed else tgs.sample_plane_bilinear
    want = jf(jnp.asarray(plane), jnp.asarray(coords))
    got = tf(_t(plane), _t(coords))
    assert got.shape == want.shape
    # same arithmetic on the same (rounded) operands
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_render_staging_shapes_match_jax(monkeypatch):
    """pack_grids_for_render stages, on CPU tensors too, the same tables
    as the JAX package does with its kernels enabled (PALLAS_INTERPRET
    on): big F = 32 tables unpacked [h*w, F], the rest quad-packed
    [h*w, 4F], all bf16, with the same values."""
    monkeypatch.setattr(jgs, "PALLAS_INTERPRET", True)
    rng = np.random.default_rng(13)
    reso = (256, 256, 256, 3)  # XY/XZ/YZ 256x256 qualify; time planes do not
    grids = [[rng.uniform(0.1, 0.5, (reso[c2], reso[c1], 32)).astype(np.float32)
              for c1, c2 in tkpf.plane_combinations(4)]]
    want = jkpf.pack_grids_for_render(
        {"grids": [[jnp.asarray(g) for g in gs] for gs in grids]}
    )["grids_packed"]
    got = tkpf.pack_grids_for_render(
        {"grids": [[_t(g) for g in gs] for gs in grids]}
    )["grids_packed"]
    kinds = set()
    for gt, wt in zip(got[0], want[0]):
        assert tuple(gt.shape) == tuple(wt.shape)
        assert gt.dtype == torch.bfloat16 and wt.dtype == jnp.bfloat16
        np.testing.assert_array_equal(gt.float().numpy(),
                                      np.asarray(wt.astype(jnp.float32)))
        kinds.add(gt.shape[-1])
    assert kinds == {32, 128}                 # both stagings exercised


@pytest.mark.parametrize("unpacked", [False, True])
def test_staged_interpolation_matches_jax(unpacked):
    """interpolate_kplanes over staged tables (grouped kernel dispatch, in
    ray order) == JAX's unsorted interpolate_kplanes; 256x256 XZ planes
    stage unpacked, 64x64 ones quad-packed.  Products of six
    bf16-gathered planes in another order: 1e-5 of the max."""
    rng = np.random.default_rng(14)
    reso = (256, 8, 256, 5) if unpacked else (64, 8, 64, 5)
    grids = [[rng.uniform(0.1, 0.5, (reso[c2], reso[c1], 32)).astype(np.float32)
              for c1, c2 in tkpf.plane_combinations(4)] for _ in range(2)]
    pts = rng.uniform(-1.05, 1.05, (700, 4)).astype(np.float32)
    want = np.asarray(jkpf.interpolate_kplanes(
        jnp.asarray(pts), [[jnp.asarray(g) for g in gs] for gs in grids],
        concat_features=True,
    ))
    tgrids = [[_t(g) for g in gs] for gs in grids]
    staged = tkpf.pack_grids_for_render({"grids": tgrids})
    assert any(t.shape[-1] == 32 for t in staged["grids_packed"][0]) == unpacked
    got = tkpf.interpolate_kplanes(_t(pts), tgrids, concat_features=True,
                                   ms_packed=staged["grids_packed"])
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy() / scale, want / scale, atol=1e-5)


def test_static_query_samples_spatial_planes():
    """A 4D model queried without times samples XY, XZ and YZ (grid
    indices 0, 1, 3), as the JAX package does."""
    assert tkpf._sampled_planes(3, 6) == jkpf._sampled_planes(3, 6)
    assert [ci for ci, _ in tkpf._sampled_planes(3, 6)] == [0, 1, 3]
    rng = np.random.default_rng(15)
    grids = [[rng.uniform(0.1, 0.5, (r2, r1, 32)).astype(np.float32)
              for r1, r2 in ((8, 10), (8, 12), (8, 5), (10, 12), (10, 5), (12, 5))]]
    pts = rng.uniform(-1, 1, (200, 3)).astype(np.float32)
    want = np.asarray(jkpf.interpolate_kplanes(
        jnp.asarray(pts), [[jnp.asarray(g) for g in grids[0]]],
        concat_features=True))
    tgrids = [[_t(g) for g in grids[0]]]
    staged = tkpf.pack_grids_for_render({"grids": tgrids})
    got = tkpf.interpolate_kplanes(_t(pts), tgrids, concat_features=True,
                                   ms_packed=staged["grids_packed"])
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_wrappers_take_plain_versions_on_cpu():
    """On CPU tensors the wrappers take the plain versions and count no
    launch."""
    tpk.reset_launch_counts()
    table = torch.zeros((12, 32), dtype=torch.bfloat16)
    z = torch.zeros(5, dtype=torch.int32)
    f = torch.zeros(5)
    tpk.bilerp_fwd_unpacked([table], [z], [f], f, h=3, w=4)
    tpk.bilerp_fwd_packed([torch.zeros((12, 128), dtype=torch.bfloat16)],
                          [z], [f], f)
    assert tpk.bilerp_fwd_unpacked.launches == 0
    assert tpk.bilerp_fwd_packed.launches == 0
