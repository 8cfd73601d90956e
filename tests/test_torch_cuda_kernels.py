"""The port's CUDA kernels (plane sampling forward and backward, the hash
grids' row scatter-add) against their plain versions, on the card.

Needs CUDA and nvcc; everywhere else each test skips.  Imports neither JAX
nor the JAX package (the card's machine has neither), so run it without
the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py
"""
import numpy as np
import pytest
import torch

from soccernerfs_tpu_torch.ops.kernels import plane_kernels as pk
from soccernerfs_tpu_torch.ops.kernels import scatter_kernels as sk

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _points(rng, h, w, m, planes, dev, sort=False):
    """Row ids in any order (or sorted by y), x fractions per plane and one
    shared y fraction, with exact right/bottom border cells."""
    y = rng.uniform(0, h - 1, m).astype(np.float32)
    y[3:7] = h - 1
    if sort:
        y.sort()
    yc = y.astype(np.int32)
    rowids, txs = [], []
    for _ in range(planes):
        x = rng.uniform(0, w - 1, m).astype(np.float32)
        x[:5] = w - 1
        xc = x.astype(np.int32)
        rowids.append(torch.from_numpy(yc * w + xc).to(dev))
        txs.append(torch.from_numpy((x - xc).astype(np.float32)).to(dev))
    return rowids, txs, torch.from_numpy((y - yc).astype(np.float32)).to(dev)


CASES = [  # h, w, m, planes, feat
    (25, 16, 700, 2, 32),
    (9, 8, 99, 1, 32),
    (20, 12, 900, 3, 32),
    (100, 16, 555, 3, 32),
    (13, 7, 1001, 3, 8),
    (1, 1, 10, 1, 8),
]
# the other compiled widths of the registry and the paper's sweeps (16,
# 24, 48) and one the wrappers pad (20 -> 24)
WIDTH_CASES = [
    (25, 16, 700, 2, 16),
    (20, 12, 901, 3, 24),
    (13, 7, 1001, 3, 48),
    (9, 8, 99, 2, 20),
]


@pytest.mark.parametrize("sort", [False, True])
@pytest.mark.parametrize("h,w,m,planes,feat", CASES + WIDTH_CASES)
def test_unpacked_kernel_matches_plain(dev, h, w, m, planes, feat, sort):
    """Each multiply and add rounds as the plain version's ops do, so the
    kernel equals it to 1e-6 relative (bit-equal in practice)."""
    rng = np.random.default_rng(h * 1000 + w)
    tables = [torch.from_numpy(rng.standard_normal((h * w, feat), dtype=np.float32))
              .to(dev, torch.bfloat16) for _ in range(planes)]
    rowids, txs, ty = _points(rng, h, w, m, planes, dev, sort)
    before = pk.bilerp_fwd_unpacked.launches
    got = pk.bilerp_fwd_unpacked(tables, rowids, txs, ty, h=h, w=w)
    want = pk.bilerp_fwd_unpacked_plain(tables, rowids, txs, ty, h=h, w=w)
    torch.cuda.synchronize()
    assert pk.bilerp_fwd_unpacked.launches == before + 1
    for g, e in zip(got, want):
        torch.testing.assert_close(g, e, rtol=1e-6, atol=0)


@pytest.mark.parametrize("sort", [False, True])
@pytest.mark.parametrize("h,w,m,planes,feat", CASES + WIDTH_CASES)
def test_packed_kernel_matches_plain(dev, h, w, m, planes, feat, sort):
    rng = np.random.default_rng(h * 1000 + w + 1)
    tables = [torch.from_numpy(rng.standard_normal((h * w, 4 * feat),
                                                   dtype=np.float32))
              .to(dev, torch.bfloat16) for _ in range(planes)]
    rowids, txs, ty = _points(rng, h, w, m, planes, dev, sort)
    before = pk.bilerp_fwd_packed.launches
    got = pk.bilerp_fwd_packed(tables, rowids, txs, ty)
    want = pk.bilerp_fwd_packed_plain(tables, rowids, txs, ty)
    torch.cuda.synchronize()
    assert pk.bilerp_fwd_packed.launches == before + 1
    for g, e in zip(got, want):
        torch.testing.assert_close(g, e, rtol=1e-6, atol=0)


# many points on a 2x2 table: every add contends with thousands of others
COLLISION_CASES = [(2, 2, 20000, 2, 32), (2, 2, 20000, 3, 8)]


def _assert_close_to_plain(got, want):
    """Atomics add in an order that changes from run to run: 1e-5 of the
    max magnitude, not bit for bit."""
    for g, e in zip(got, want):
        assert g.shape == e.shape and g.dtype == torch.float32
        scale = float(e.abs().max())
        assert float((g - e).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("sort", [False, True])
@pytest.mark.parametrize("h,w,m,planes,feat",
                         CASES + COLLISION_CASES + WIDTH_CASES)
def test_unpacked_bwd_kernel_matches_plain(dev, h, w, m, planes, feat, sort):
    rng = np.random.default_rng(h * 1000 + w + 2)
    gs = [torch.from_numpy(rng.standard_normal((m, feat), dtype=np.float32)).to(dev)
          for _ in range(planes)]
    rowids, txs, ty = _points(rng, h, w, m, planes, dev, sort)
    before = pk.bilerp_bwd_unpacked.launches
    got = pk.bilerp_bwd_unpacked(gs, rowids, txs, ty, h=h, w=w)
    want = pk.bilerp_bwd_unpacked_plain(gs, rowids, txs, ty, h=h, w=w)
    torch.cuda.synchronize()
    assert pk.bilerp_bwd_unpacked.launches == before + 1
    _assert_close_to_plain(got, want)


@pytest.mark.parametrize("sort", [False, True])
@pytest.mark.parametrize("h,w,m,planes,feat",
                         CASES + COLLISION_CASES + WIDTH_CASES)
def test_packed_bwd_kernel_matches_plain(dev, h, w, m, planes, feat, sort):
    rng = np.random.default_rng(h * 1000 + w + 3)
    gs = [torch.from_numpy(rng.standard_normal((m, feat), dtype=np.float32)).to(dev)
          for _ in range(planes)]
    rowids, txs, ty = _points(rng, h, w, m, planes, dev, sort)
    before = pk.bilerp_bwd_packed.launches
    got = pk.bilerp_bwd_packed(gs, rowids, txs, ty, rows=h * w)
    want = pk.bilerp_bwd_packed_plain(gs, rowids, txs, ty, rows=h * w)
    torch.cuda.synchronize()
    assert pk.bilerp_bwd_packed.launches == before + 1
    _assert_close_to_plain(got, want)


def _runs(rng, h, w, lengths, planes, dev, border=False):
    """Points in runs: within a run every point has the same row id on each
    plane (one cell, random fractions), as consecutive samples of a ray
    often do; with ``border`` each run's cell is on the right or bottom
    border (or both), where two corners fold onto one row."""
    m = int(sum(lengths))
    run_of = np.repeat(np.arange(len(lengths)), lengths)
    yc = rng.integers(0, h, len(lengths))
    xcs = [rng.integers(0, w, len(lengths)) for _ in range(planes)]
    if border:
        side = rng.integers(0, 3, len(lengths))   # right, bottom, corner
        yc[side > 0] = h - 1
        for xc in xcs:
            xc[side != 1] = w - 1
    rowids = [torch.from_numpy((yc * w + xc)[run_of].astype(np.int32)).to(dev)
              for xc in xcs]
    txs = [torch.from_numpy(rng.uniform(0, 1, m).astype(np.float32)).to(dev)
           for _ in range(planes)]
    ty = torch.from_numpy(rng.uniform(0, 1, m).astype(np.float32)).to(dev)
    return rowids, txs, ty


# run lengths: long runs of one row; runs that cross the edges of a strip
# (8 points), a warp (32 points at F = 32, 128 at F = 8) and a block (256,
# 1024); every point on one row; runs on border cells; a point count that
# is not a multiple of the strip, and one below it
RUN_PATTERNS = {
    "long": lambda rng: rng.integers(1, 40, 60),
    "edges": lambda rng: [7, 9, 33, 257, 1025, 1, 2, 3, 127, 129, 300],
    "one_row": lambda rng: [4000],
    "border": lambda rng: rng.integers(1, 20, 80),
    "ragged": lambda rng: [3, 12, 6, 2],
    "short": lambda rng: [5],
}


@pytest.mark.parametrize("pattern", list(RUN_PATTERNS))
@pytest.mark.parametrize("planes", [1, 2, 3])
@pytest.mark.parametrize("feat", [8, 32])
@pytest.mark.parametrize("kind", ["unpacked", "packed"])
def test_bwd_kernels_merge_runs_of_one_row(dev, kind, feat, planes, pattern):
    """Runs of equal row ids, which the kernels sum in registers before
    their atomics, give the plain version's table gradient."""
    h, w = 9, 16
    rng = np.random.default_rng([feat, planes, len(pattern)])
    lengths = RUN_PATTERNS[pattern](rng)
    rowids, txs, ty = _runs(rng, h, w, lengths, planes, dev,
                            border=pattern == "border")
    m = ty.shape[0]
    gs = [torch.from_numpy(rng.standard_normal((m, feat), dtype=np.float32)).to(dev)
          for _ in range(planes)]
    kernel = getattr(pk, f"bilerp_bwd_{kind}")
    shape = {"h": h, "w": w} if kind == "unpacked" else {"rows": h * w}
    before = kernel.launches
    got = kernel(gs, rowids, txs, ty, **shape)
    want = getattr(pk, f"bilerp_bwd_{kind}_plain")(gs, rowids, txs, ty, **shape)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    _assert_close_to_plain(got, want)


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    table = torch.zeros((12, 32), dtype=torch.bfloat16, device=dev)
    z = torch.zeros(5, dtype=torch.int32, device=dev)
    f = torch.zeros(5, device=dev)
    with pytest.raises(ValueError):      # f32 table
        pk.bilerp_fwd_unpacked([table.float()], [z], [f], f, h=3, w=4)
    with pytest.raises(ValueError):      # wrong row count
        pk.bilerp_fwd_unpacked([table], [z], [f], f, h=4, w=4)
    with pytest.raises(ValueError):      # 4 planes
        pk.bilerp_fwd_unpacked([table] * 4, [z] * 4, [f] * 4, f, h=3, w=4)
    with pytest.raises(ValueError):      # int64 row ids
        pk.bilerp_fwd_unpacked([table], [z.long()], [f], f, h=3, w=4)
    with pytest.raises(ValueError):      # ty of another length
        pk.bilerp_fwd_unpacked([table], [z], [f], f[:4], h=3, w=4)
    with pytest.raises(ValueError):      # mixed devices
        pk.bilerp_fwd_packed([torch.zeros((3, 128), dtype=torch.bfloat16,
                                          device=dev)], [z.cpu()], [f], f)
    with pytest.raises(ValueError):      # F = 136: no kernel above 128
        pk.bilerp_fwd_packed([torch.zeros((3, 544), dtype=torch.bfloat16,
                                          device=dev)], [z], [f], f)
    g = torch.zeros((5, 32), device=dev)
    with pytest.raises(ValueError):      # bf16 upstream gradient
        pk.bilerp_bwd_unpacked([g.to(torch.bfloat16)], [z], [f], f, h=3, w=4)
    with pytest.raises(ValueError):      # gradient rows != points
        pk.bilerp_bwd_unpacked([g[:4]], [z], [f], f, h=3, w=4)
    with pytest.raises(ValueError):      # non-contiguous gradient
        pk.bilerp_bwd_packed([torch.zeros((32, 5), device=dev).t()], [z], [f],
                             f, rows=12)
    with pytest.raises(ValueError):      # F = 136: no kernel above 128
        pk.bilerp_bwd_packed([torch.zeros((5, 136), device=dev)], [z], [f], f,
                             rows=12)


# ---------------------------------------------------------------------------
# kplanes_fwd_fused: one K-Planes scale per launch
# ---------------------------------------------------------------------------

def _fused_operands(rng, dim, feat, reso, m, dev):
    """Every k-choose-2 plane of ``reso`` ([res_c2, res_c1] each), staged
    alternately quad-packed [h*w, 4F] and unpacked [h*w, F] (the feature
    axis zero-padded to native_feat(F), as stage_table stages it); points
    in [-1.1, 1.1]^dim with rows exactly at -1 and +1 (the border cells)."""
    from soccernerfs_tpu_torch.ops.grid_sample import quad_pack

    planes, tables = [], []
    for i, (c1, c2) in enumerate((a, b) for a in range(dim)
                                 for b in range(a + 1, dim)):
        h, w = reso[c2], reso[c1]
        plane = torch.from_numpy(rng.uniform(0.1, 0.5, (h, w, feat))
                                 .astype(np.float32)).to(dev, torch.bfloat16)
        tables.append(pk.pad_features(plane.reshape(h * w, feat), feat).contiguous()
                      if i % 2 else
                      pk.pad_features(quad_pack(plane), feat, 4).contiguous())
        planes.append((c1, c2, h, w))
    pts = rng.uniform(-1.1, 1.1, (m, dim)).astype(np.float32)
    pts[:2] = [[-1.0] * dim, [1.0] * dim]
    pts[2:12] = rng.choice([-1.0, 1.0], (10, dim))
    return torch.from_numpy(pts).to(dev), tables, planes


# dim, feat, reso, m (never a multiple of a block's 256 / (F / 8) points)
FUSED_CASES = [
    (4, 32, (25, 16, 20, 7), 1001),
    (4, 8, (13, 7, 9, 5), 3333),
    (3, 32, (64, 32, 16), 777),
    (3, 8, (1, 5, 3), 299),
    (4, 32, (256, 256, 128, 6), 40_001),
    (4, 24, (25, 16, 20, 7), 1001),      # kp_res_study's width
    (4, 16, (13, 7, 9, 5), 3333),
    (3, 48, (64, 32, 16), 777),
    (4, 20, (25, 16, 20, 7), 999),       # padded to 24
]


@pytest.mark.parametrize("dim,feat,reso,m", FUSED_CASES)
def test_fused_kernel_matches_plain(dev, dim, feat, reso, m):
    """Cells, fractions, lerps and the ordered product round as the plain
    version's ops do: bit-equal, both layouts in one launch, into a
    column slice of the concatenated features (scale 1 of 3) with its
    neighbours untouched."""
    rng = np.random.default_rng(dim * 100 + feat + m)
    pts, tables, planes = _fused_operands(rng, dim, feat, reso, m, dev)
    got = torch.full((m, 3 * feat), -7.0, device=dev)
    want = torch.full((m, 3 * feat), -7.0, device=dev)
    before = pk.kplanes_fwd_fused.launches
    out = pk.kplanes_fwd_fused(pts, tables, planes, got[:, feat:2 * feat])
    pk.kplanes_fwd_fused_plain(pts, tables, planes, want[:, feat:2 * feat])
    torch.cuda.synchronize()
    assert pk.kplanes_fwd_fused.launches == before + 1
    assert out.data_ptr() == got[:, feat:].data_ptr()
    assert torch.equal(got, want)
    assert bool((got[:, :feat] == -7.0).all() and (got[:, 2 * feat:] == -7.0).all())


@pytest.mark.parametrize("planes", [1, 2, 5])
def test_fused_kernel_takes_any_plane_count(dev, planes):
    """1..6 planes a launch (the render path's 3 and 6, and the rest)."""
    rng = np.random.default_rng(planes)
    pts, tables, descs = _fused_operands(rng, 4, 32, (12, 10, 8, 6), 500, dev)
    got = pk.kplanes_fwd_fused(pts, tables[:planes], descs[:planes],
                               torch.empty((500, 32), device=dev))
    want = pk.kplanes_fwd_fused_plain(pts, tables[:planes], descs[:planes],
                                      torch.empty((500, 32), device=dev))
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_fused_wrapper_refuses_what_the_kernel_does_not_take(dev):
    rng = np.random.default_rng(0)
    pts, tables, planes = _fused_operands(rng, 4, 8, (6, 5, 4, 3), 20, dev)
    out = torch.empty((20, 8), device=dev)
    with pytest.raises(ValueError):      # 7 planes
        pk.kplanes_fwd_fused(pts, tables + tables[:1], planes + planes[:1], out)
    with pytest.raises(ValueError):      # one descriptor short
        pk.kplanes_fwd_fused(pts, tables, planes[:-1], out)
    with pytest.raises(ValueError):      # 2-D points
        pk.kplanes_fwd_fused(pts[:, :2].contiguous(), tables[:1],
                             planes[:1], out)
    with pytest.raises(ValueError):      # a plane reading the missing time axis
        pk.kplanes_fwd_fused(pts[:, :3].contiguous(), tables, planes, out)
    with pytest.raises(ValueError):      # f32 table
        pk.kplanes_fwd_fused(pts, [tables[0].float()], planes[:1], out)
    with pytest.raises(ValueError):      # table rows != h * w
        pk.kplanes_fwd_fused(pts, tables[:1], [(0, 1, 4, 6)], out)
    with pytest.raises(ValueError):      # out 16 wide, tables of F = 8
        pk.kplanes_fwd_fused(pts, tables[:1], planes[:1],
                             torch.empty((20, 16), device=dev))
    with pytest.raises(ValueError):      # F = 136: no kernel above 128
        pk.kplanes_fwd_fused(pts, tables[:1], planes[:1],
                             torch.empty((20, 136), device=dev))
    with pytest.raises(ValueError):      # rows 14 floats apart: not 16-byte aligned
        pk.kplanes_fwd_fused(pts, tables[:1], planes[:1],
                             torch.empty((20, 14), device=dev)[:, :8])
    with pytest.raises(ValueError):      # points on the CPU, tables on the card
        pk.kplanes_fwd_fused(pts.cpu(), tables, planes, out)
    with pytest.raises(ValueError):      # non-contiguous points
        pk.kplanes_fwd_fused(torch.zeros((4, 20), device=dev).t(), tables,
                             planes, out)


# ---------------------------------------------------------------------------
# scatter_add_rows
# ---------------------------------------------------------------------------

SCATTER_CASES = [  # rows, c, groups, corners, points
    (1000, 2, 1, 1, 5000),       # sorted_scatter_add's own shape
    (1000, 2, 4, 8, 3000),       # a hash grid: levels x corners
    (777, 4, 3, 8, 2000),
    (64, 1, 2, 4, 999),
    (500, 8, 2, 2, 1500),
    (300, 16, 1, 8, 700),
    (200, 32, 2, 1, 800),
    (50, 128, 1, 2, 300),
    (2, 2, 1, 1, 100_000),       # every add contends with 50,000 others
    (2, 4, 2, 8, 20_000),
    (1 << 19, 2, 16, 8, 60_000),  # a table past the shared-memory window;
    (6000, 1, 16, 8, 60_000),     # each lane walks many items of its block
    (330_000, 1, 16, 32, 3000),   # the temporal main grid's width-1 launch:
                                  # 16 levels of 8 corners x 4 picked entries
]


def _scatter_operands(rows, c, groups, corners, points, dev, sort, weights):
    rng = np.random.default_rng(rows * 31 + c)
    idx = rng.integers(0, rows, (groups, corners, points)).astype(np.int32)
    if sort:
        idx.sort(axis=-1)
    g = rng.standard_normal((points, groups * c), dtype=np.float32)
    ws = (rng.uniform(0, 1, idx.shape).astype(np.float32) if weights else None)
    return (torch.from_numpy(g).to(dev), torch.from_numpy(idx).to(dev),
            None if ws is None else torch.from_numpy(ws).to(dev))


@pytest.mark.parametrize("weights", [False, True])
@pytest.mark.parametrize("sort", [False, True])
@pytest.mark.parametrize("rows,c,groups,corners,points", SCATTER_CASES)
def test_scatter_kernel_matches_plain(dev, rows, c, groups, corners, points,
                                      sort, weights):
    """Each product rounds as the plain version's; atomics add in an order
    that changes from run to run, and a row's sum of up to 160,000 signed
    terms cancels, so the sums are held to 1e-6 of the largest row's sum of
    |terms| (what f32 rounding scales with), not to the result's size."""
    g, idx, ws = _scatter_operands(rows, c, groups, corners, points, dev, sort,
                                   weights)
    before = sk.scatter_add_rows.launches
    got = sk.scatter_add_rows(g, idx, ws, rows=rows)
    torch.cuda.synchronize()
    sk.raise_if_out_of_range(dev)
    assert sk.scatter_add_rows.launches == before + 1
    _assert_scatter_close(got, g, idx, ws, rows)


def test_scatter_kernel_empty_update_list(dev):
    g = torch.zeros((0, 4), device=dev)
    idx = torch.zeros((2, 8, 0), dtype=torch.int32, device=dev)
    before = sk.scatter_add_rows.launches
    out = sk.scatter_add_rows(g, idx, None, rows=9)
    assert out.shape == (9, 2) and float(out.abs().max()) == 0.0
    assert sk.scatter_add_rows.launches == before      # nothing to launch


def test_scatter_wrapper_refuses_what_the_kernel_does_not_take(dev):
    g = torch.zeros((5, 4), device=dev)
    idx = torch.zeros((2, 3, 5), dtype=torch.int32, device=dev)
    w = torch.ones((2, 3, 5), device=dev)
    with pytest.raises(ValueError):      # int64 indices
        sk.scatter_add_rows(g, idx.long(), w, rows=7)
    with pytest.raises(ValueError):      # bf16 gradient
        sk.scatter_add_rows(g.to(torch.bfloat16), idx, w, rows=7)
    with pytest.raises(ValueError):      # width 3 per group
        sk.scatter_add_rows(torch.zeros((5, 6), device=dev), idx, w, rows=7)
    with pytest.raises(ValueError):      # weights of another shape
        sk.scatter_add_rows(g, idx, w[:, :2], rows=7)
    with pytest.raises(ValueError):      # mixed devices
        sk.scatter_add_rows(g, idx.cpu(), w, rows=7)
    with pytest.raises(ValueError):      # non-contiguous gradient
        sk.scatter_add_rows(torch.zeros((4, 5), device=dev).t(), idx, w, rows=7)
    sk.raise_if_out_of_range(dev)
    for bad in (-1, 7):                  # a row outside the table: no clip
        idx2 = idx.clone()
        idx2[1, 2, 3] = bad
        sk.scatter_add_rows(g, idx2, w, rows=7)
        with pytest.raises(IndexError):  # the deferred check
            sk.raise_if_out_of_range(dev)
        sk.raise_if_out_of_range(dev)    # and it cleared the flag


def _assert_scatter_close(got, g, idx, ws, rows):
    """1e-6 of the largest row's sum of |terms| (see
    test_scatter_kernel_matches_plain)."""
    want = sk.scatter_add_rows_plain(g, idx, ws, rows=rows)
    mass = sk.scatter_add_rows_plain(g.abs(), idx, ws, rows=rows)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert float((got - want).abs().max()) <= 1e-6 * float(mass.max())


def _pair_runs(rng, lengths, lo, hi, corners):
    """[corners, points] rows in [lo, hi) in runs of equal rows (consecutive
    samples of a ray in one cell): corners 2m, 2m+1 are a z-pair r, r+1 at
    random (even and odd) r; every fifth run's pairs start at the level's
    last row and wrap to its first, as the hashes' modulo does."""
    base = rng.integers(lo, hi - 1, (corners // 2, len(lengths)))
    base[:, ::5] = hi - 1
    top = np.where(base + 1 < hi, base + 1, lo)
    rows = np.stack([base, top], 1).reshape(corners, len(lengths))
    return np.repeat(rows, lengths, axis=1)


# run lengths along consecutive points: 1, 2, one strip (8 points for
# c <= 2, 4 wider), longer than a strip, and mixed
PAIR_RUNS = {
    "ones": lambda rng: [1] * 500,
    "twos": lambda rng: [2] * 300,
    "strip": lambda rng: [8] * 90 + [4] * 40,
    "long": lambda rng: [20, 9, 33, 100, 7, 1, 64, 300, 17, 5],
    "mixed": lambda rng: rng.integers(1, 40, 80),
}


@pytest.mark.parametrize("pattern", list(PAIR_RUNS))
@pytest.mark.parametrize("c", sk.CHANNELS)
def test_scatter_kernel_merges_runs_of_one_row(dev, c, pattern):
    """Two levels of one table, as a hash grid has them: a dense 4096-row
    level 0 the kernel sums in shared memory (for c <= 2) and a 300,000-row
    level 1 past its window; runs of one row along consecutive points, for
    z-pairs of corners on neighbouring rows at even and odd first rows and
    wrapping at a level's end."""
    rng = np.random.default_rng([c, len(pattern)])
    lengths = PAIR_RUNS[pattern](rng)
    dense, rows = 4096, 4096 + 300_000
    idx = np.stack([_pair_runs(rng, lengths, 0, dense, 8),
                    _pair_runs(rng, lengths, dense, rows, 8)]).astype(np.int32)
    points = idx.shape[-1]
    g = torch.from_numpy(rng.standard_normal((points, 2 * c), dtype=np.float32)).to(dev)
    ws = torch.from_numpy(rng.uniform(0, 1, idx.shape).astype(np.float32)).to(dev)
    idx = torch.from_numpy(idx).to(dev)
    assert 0 < sk.shared_rows(rows, c) < rows
    before = sk.scatter_add_rows.launches
    got = sk.scatter_add_rows(g, idx, ws, rows=rows)
    torch.cuda.synchronize()
    sk.raise_if_out_of_range(dev)
    assert sk.scatter_add_rows.launches == before + 1
    _assert_scatter_close(got, g, idx, ws, rows)


def test_scatter_wrapper_never_synchronises(dev):
    """At the nerfacto main grid's shape (16 levels of 2 channels, 196,608
    points, 6,098,120 rows) the wrapper launches under
    torch.cuda.set_sync_debug_mode("error"), which turns any host-device
    sync into an error; the deferred range check afterwards finds
    nothing."""
    from soccernerfs_tpu_torch.ops.hash_grid import (HashGridConfig, grid_corners,
                                                     level_layout)

    cfg = HashGridConfig(num_levels=16, desired_resolution=2048,
                         hash_scheme="zline")
    gen = torch.Generator(device=dev).manual_seed(0)
    idx, ws = grid_corners(cfg, torch.rand((196_608, 3), generator=gen, device=dev))
    idx, ws = idx.contiguous(), ws.contiguous()
    g = torch.randn((196_608, 32), generator=gen, device=dev)
    rows = level_layout(cfg)[0][-1]
    sk.scatter_add_rows(g, idx, ws, rows=rows)     # builds, makes the flag
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = sk.scatter_add_rows(g, idx, ws, rows=rows)
        with pytest.raises(RuntimeError):          # the mode is on
            float(got[0, 0])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    sk.raise_if_out_of_range(dev)
    _assert_scatter_close(got, g, idx, ws, rows)


def test_temporal_encode_on_the_card_matches_the_cpu(dev):
    """A temporal grid (3 levels, 8 temporal channels: dense and hashed
    levels) encoded on the card and on the CPU from the same table, points
    and times: values to 1e-6 of the max (the same f32 gathers and
    products in the same order); the table gradient, one width-1
    scatter_add_rows launch over the flattened table (3 levels of 8
    corners x 4 picked entries), to 1e-5 of the max (atomics against the
    plain version's f64 sum)."""
    from soccernerfs_tpu_torch.ops.hash_grid import (HashGridConfig,
                                                     hash_grid_encode,
                                                     level_layout)

    cfg = HashGridConfig(temporal_dim=8, num_levels=3, base_resolution=4,
                         desired_resolution=64, log2_hashmap_size=10)
    rng = np.random.default_rng(40)
    rows = level_layout(cfg)[0][-1]
    table = rng.uniform(-0.5, 0.5, (rows, cfg.row_channels)).astype(np.float32)
    x = rng.uniform(0, 1, (50_000, 3)).astype(np.float32)
    t = rng.uniform(0, 1, 50_000).astype(np.float32)
    cot = rng.standard_normal((50_000, cfg.output_dim)).astype(np.float32)
    results = {}
    for where in ("cpu", dev):
        tab = torch.from_numpy(table).to(where).requires_grad_(True)
        out = hash_grid_encode(cfg, {"embeddings": tab},
                               torch.from_numpy(x).to(where),
                               torch.from_numpy(t).to(where))
        before = sk.scatter_add_rows.launches
        (out * torch.from_numpy(cot).to(where)).sum().backward()
        results[str(where)] = (out.detach().cpu(), tab.grad.cpu())
    torch.cuda.synchronize()
    sk.raise_if_out_of_range(dev)
    assert sk.scatter_add_rows.launches == before + 1
    (out_cpu, g_cpu), (out_card, g_card) = results["cpu"], results[str(dev)]
    assert float((out_card - out_cpu).abs().max()) <= 1e-6 * float(out_cpu.abs().max())
    assert float((g_card - g_cpu).abs().max()) <= 1e-5 * float(g_cpu.abs().max())


def test_viewer_render_on_the_card_matches_the_cpu(dev):
    """A viewer request (``ViewerState.render``: rgb as PNG) of one small
    K-Planes snapshot (seeded planes, time planes with noise) rendered on
    the card, through the fused plane kernel and no per-plane forward
    kernel, and on the CPU, through its plain version: the decoded 8-bit
    colours agree within 1 in
    every channel on at least 99.9 % of the pixels (f32 reduction order
    moves a few across a rounding step)."""
    import dataclasses
    import io

    from PIL import Image

    from soccernerfs_tpu_torch.configs import method_configs as mc
    from soccernerfs_tpu_torch.convert import params_from_jax, seeded_params
    from soccernerfs_tpu_torch.engine.render import render_camera
    from soccernerfs_tpu_torch.viewer.server import ViewerState

    cfg = dataclasses.replace(
        mc.model_configs["k-planes"], spacetime_resolution=(32, 32, 32, 8),
        multiscale_res=(1, 2), feature_dim=8,
        proposal_net_args_list=({"feature_dim": 8, "resolution": (16, 16, 16, 8)},
                                {"feature_dim": 8, "resolution": (32, 32, 32, 8)}),
        num_proposal_samples_per_ray=(32, 16), num_nerf_samples_per_ray=16,
        sigma_net_hidden_dim=32, rgb_net_hidden_dim=32,
        eval_num_rays_per_chunk=2048)
    tree = seeded_params(cfg, 3, time_noise=0.05)

    class Snapshot:
        def __init__(self, where):
            self.device = torch.device(where)
            self.params = params_from_jax(tree, device=self.device)
            self.aabb = torch.tensor([[-1.5] * 3, [1.5] * 3])

        def render_camera(self, cameras, i):
            out = render_camera(cfg, self.params, cameras, i, device=self.device,
                                aabb=self.aabb, model="kplanes")
            return {k: v.cpu().numpy() for k, v in out.items()}

    c2w = np.eye(4, dtype=np.float32)[:3]
    c2w[2, 3] = 3.0
    frames = {}
    for where in ("cpu", dev):
        before = {k.__name__: k.launches for k in pk.KERNELS}
        png = ViewerState(Snapshot(where)).render(c2w.tolist(), 50.0, 96, 64,
                                                  time=0.5)
        frames[str(where)] = np.asarray(Image.open(io.BytesIO(png)), np.int16)
    launched = {k.__name__: k.launches - before[k.__name__] for k in pk.KERNELS}
    assert launched["kplanes_fwd_fused"] > 0
    assert launched["bilerp_fwd_unpacked"] == launched["bilerp_fwd_packed"] == 0
    cpu, card = frames["cpu"], frames[str(dev)]
    assert card.shape == cpu.shape == (64, 96, 3)
    assert np.mean(np.all(np.abs(card - cpu) <= 1, axis=-1)) >= 0.999
    assert cpu.std() > 0  # the snapshot renders an image, not one colour
