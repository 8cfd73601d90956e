"""The port's CUDA kernels (plane sampling forward and backward, the hash
grids' row scatter-add, the importance sampler's CDF scan and draw)
against their plain versions, on the card.

Needs CUDA and nvcc; everywhere else each test skips.  Imports neither JAX
nor the JAX package (the card's machine has neither), so run it without
the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py
"""
import numpy as np
import pytest
import torch

from soccernerfs_tpu_torch.ops.kernels import plane_kernels as pk
from soccernerfs_tpu_torch.ops.kernels import sampler_kernels as spk
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


@pytest.mark.parametrize("m", [1, 2, 3, 255, 257, 4097])
@pytest.mark.parametrize("feat", [8, 48])
def test_unpacked_kernel_two_points_a_thread(dev, feat, m):
    """A thread of the unpacked forward serves points g and g + ceil(m/2):
    at an odd m the last thread has one point, which it writes once; every
    output row bit-equal to the plain version's."""
    h, w, planes = 7, 9, 3
    rng = np.random.default_rng([feat, m])
    tables = [torch.from_numpy(rng.standard_normal((h * w, feat), dtype=np.float32))
              .to(dev, torch.bfloat16) for _ in range(planes)]
    rowids, txs, ty = _points(rng, h, w, m, planes, dev)
    got = pk.bilerp_fwd_unpacked(tables, rowids, txs, ty, h=h, w=w)
    want = pk.bilerp_fwd_unpacked_plain(tables, rowids, txs, ty, h=h, w=w)
    torch.cuda.synchronize()
    for g, e in zip(got, want):
        assert g.shape == (m, feat) and torch.equal(g, e)


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


def _packed_operands(rng, rows, feat, m, planes, dev):
    """Quad-packed bf16 tables and per-point operands whose row ids run
    past both ends of the table (the kernels clip them)."""
    tables = [torch.from_numpy(rng.standard_normal((rows, 4 * feat),
                                                   dtype=np.float32))
              .to(dev, torch.bfloat16) for _ in range(planes)]
    rowids = [torch.from_numpy(rng.integers(-3, rows + 3, m).astype(np.int32))
              .to(dev) for _ in range(planes)]
    txs = [torch.from_numpy(rng.random(m, dtype=np.float32)).to(dev)
           for _ in range(planes)]
    ty = torch.from_numpy(rng.random(m, dtype=np.float32)).to(dev)
    return tables, rowids, txs, ty


@pytest.mark.parametrize("planes", [1, 2, 3])
@pytest.mark.parametrize("m", [1, 2, 3, 255, 4097])
@pytest.mark.parametrize("feat", pk.FEATS)
def test_packed_kernel_every_width_bit_equal(dev, feat, m, planes):
    """The packed forward at every compiled width, two points a thread
    below F = 48 (g and g + ceil(m/2)): at an odd m the last thread has
    one point, which it writes once, and row ids past either end clip;
    every output row bit-equal to the plain version's."""
    rng = np.random.default_rng([feat, m, planes])
    tables, rowids, txs, ty = _packed_operands(rng, 23, feat, m, planes, dev)
    got = pk.bilerp_fwd_packed(tables, rowids, txs, ty)
    want = pk.bilerp_fwd_packed_plain(tables, rowids, txs, ty)
    torch.cuda.synchronize()
    for g, e in zip(got, want):
        assert g.shape == (m, feat) and torch.equal(g, e)


@pytest.mark.parametrize("feat", [8, 24, 32, 48])
def test_packed_kernel_tables_past_l2_bit_equal(dev, feat):
    """Tables whose launch outgrows the 50 MB L2 (rows gathered from DRAM)
    and a small one in the same width: bit-equal both."""
    l2 = torch.cuda.get_device_properties(dev).L2_cache_size
    for rows in (1000, l2 // (8 * feat) + 4099):
        rng = np.random.default_rng([feat, rows])
        tables, rowids, txs, ty = _packed_operands(rng, rows, feat, 100_003, 2,
                                                   dev)
        got = pk.bilerp_fwd_packed(tables, rowids, txs, ty)
        want = pk.bilerp_fwd_packed_plain(tables, rowids, txs, ty)
        torch.cuda.synchronize()
        assert all(torch.equal(g, e) for g, e in zip(got, want)), rows


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


@pytest.mark.parametrize("sort", [False, True])
@pytest.mark.parametrize("layout", ["unpacked", "packed"])
@pytest.mark.parametrize("h,w,m,planes,feat", CASES + WIDTH_CASES)
def test_coords_bwd_kernel_matches_plain(dev, h, w, m, planes, feat, layout,
                                         sort):
    """bilerp_bwd_coords against its plain version on staged tables of
    either layout (a padded width's extra columns zero, as stage_table
    stages them): 1e-5 of the largest |gradient| (the sums over F run in
    another order); across the right border (its two corners one value)
    the x fraction's gradient is exactly 0."""
    from soccernerfs_tpu_torch.ops.grid_sample import quad_pack

    rng = np.random.default_rng(h * 1000 + w + 4)
    wide = pk.native_feat(feat)
    planes_ = [torch.nn.functional.pad(
        torch.from_numpy(rng.standard_normal((h, w, feat), dtype=np.float32)),
        (0, wide - feat)).to(dev, torch.bfloat16) for _ in range(planes)]
    tables = [(p.reshape(h * w, wide) if layout == "unpacked" else quad_pack(p))
              .contiguous() for p in planes_]
    gs = [torch.from_numpy(rng.standard_normal((m, feat), dtype=np.float32)).to(dev)
          for _ in range(planes)]
    rowids, txs, ty = _points(rng, h, w, m, planes, dev, sort)
    before = pk.bilerp_bwd_coords.launches
    got_tx, got_ty = pk.bilerp_bwd_coords(tables, gs, rowids, txs, ty, h=h, w=w)
    want_tx, want_ty = pk.bilerp_bwd_coords_plain(tables, gs, rowids, txs, ty,
                                                  h=h, w=w)
    torch.cuda.synchronize()
    assert pk.bilerp_bwd_coords.launches == before + 1
    got, want = [*got_tx, got_ty], [*want_tx, want_ty]
    scale = max(float(e.abs().max()) for e in want)
    for g, e in zip(got, want):
        assert g.shape == (m,) and g.dtype == torch.float32
        assert float((g - e).abs().max()) <= 1e-5 * scale
    if not sort:
        # _points puts the first five points on the right border
        assert all(not bool(g[:5].any()) for g in got_tx)


@pytest.mark.parametrize("layout", ["unpacked", "packed"])
@pytest.mark.parametrize("feat", [24, 48])
def test_coords_bwd_kernel_at_the_borders(dev, feat, layout):
    """F = 24 and 48 (4 and 8 lanes a point, one and two of them idle),
    three planes, runs of points on the right border, the bottom border and
    the corner cell: within 1e-5 of the largest |gradient| of the plain
    version; across the right border the x fractions' gradients, and
    across the bottom border the y fraction's, are exactly 0."""
    from soccernerfs_tpu_torch.ops.grid_sample import quad_pack

    h, w = 11, 13
    rng = np.random.default_rng([feat, len(layout)])
    rowids, txs, ty = _runs(rng, h, w, rng.integers(1, 20, 80), 3, dev,
                            border=True)
    m = ty.shape[0]
    planes = [torch.from_numpy(rng.standard_normal((h, w, feat), dtype=np.float32))
              .to(dev, torch.bfloat16) for _ in range(3)]
    tables = [(p.reshape(h * w, feat) if layout == "unpacked" else quad_pack(p))
              .contiguous() for p in planes]
    gs = [torch.from_numpy(rng.standard_normal((m, feat), dtype=np.float32)).to(dev)
          for _ in range(3)]
    got_tx, got_ty = pk.bilerp_bwd_coords(tables, gs, rowids, txs, ty, h=h, w=w)
    want_tx, want_ty = pk.bilerp_bwd_coords_plain(tables, gs, rowids, txs, ty,
                                                  h=h, w=w)
    torch.cuda.synchronize()
    got, want = [*got_tx, got_ty], [*want_tx, want_ty]
    scale = max(float(e.abs().max()) for e in want)
    for g, e in zip(got, want):
        assert float((g - e).abs().max()) <= 1e-5 * scale
    for g, r in zip(got_tx, rowids):
        right = r % w == w - 1
        assert bool(right.any()) and not bool(g[right].any())
    bottom = rowids[0] // w == h - 1
    assert bool(bottom.any()) and not bool(got_ty[bottom].any())


@pytest.mark.parametrize("w", [1, 2, 3, 5, 7, 31, 33, 100, 1000, 1023, 1025,
                               4097])
def test_unpacked_kernels_find_the_border_at_any_width(dev, w):
    """Every cell of a 5-row table of width w, in order: the kernels form
    x0 = row mod w with the host's division constants (row_divisor), so
    the forward is bit-equal to its plain version at every column and the
    coordinate backward within 1e-5 of it, its x gradient exactly 0 on the
    last column."""
    h, feat = 5, 8
    rng = np.random.default_rng(w)
    table = torch.from_numpy(rng.standard_normal((h * w, feat), dtype=np.float32)
                             ).to(dev, torch.bfloat16)
    rowid = torch.arange(h * w, dtype=torch.int32, device=dev)
    tx = torch.from_numpy(rng.uniform(0, 1, h * w).astype(np.float32)).to(dev)
    ty = torch.from_numpy(rng.uniform(0, 1, h * w).astype(np.float32)).to(dev)
    g = torch.from_numpy(rng.standard_normal((h * w, feat), dtype=np.float32)).to(dev)
    got = pk.bilerp_fwd_unpacked([table], [rowid], [tx], ty, h=h, w=w)
    want = pk.bilerp_fwd_unpacked_plain([table], [rowid], [tx], ty, h=h, w=w)
    (d_tx,), d_ty = pk.bilerp_bwd_coords([table], [g], [rowid], [tx], ty, h=h, w=w)
    (want_tx,), want_ty = pk.bilerp_bwd_coords_plain([table], [g], [rowid], [tx],
                                                     ty, h=h, w=w)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0])
    scale = max(float(want_tx.abs().max()), float(want_ty.abs().max()))
    assert float((d_tx - want_tx).abs().max()) <= 1e-5 * scale
    assert float((d_ty - want_ty).abs().max()) <= 1e-5 * scale
    assert not bool(d_tx[rowid % w == w - 1].any())


def test_kernels_take_a_table_just_under_2_31_rows(dev):
    """A [h*w, 8] bf16 table of 65535 x 32767 = 2,147,385,345 rows (32 GiB),
    just under the wrappers' refusal of 2**31 rows: the forward bit-equal
    to its plain version and the coordinate backward within 1e-5 of it,
    at 4097 points (an odd count) across the table, on its last rows, its
    last column and its last cell."""
    h, w, feat = 65535, 32767, 8
    if torch.cuda.mem_get_info(dev)[0] < h * w * feat * 2 + (4 << 30):
        pytest.skip("needs ~36 GB of free device memory")
    rng = np.random.default_rng(31)
    m = 4097
    yc = rng.integers(0, h, m)
    xc = rng.integers(0, w, m)
    yc[:100] = h - 1 - rng.integers(0, 2, 100)     # the last two rows
    xc[100:200] = w - 1                            # the last column
    yc[200], xc[200] = h - 1, w - 1                # the last cell
    rowid = torch.from_numpy((yc * w + xc).astype(np.int32)).to(dev)
    tx = torch.from_numpy(rng.uniform(0, 1, m).astype(np.float32)).to(dev)
    ty = torch.from_numpy(rng.uniform(0, 1, m).astype(np.float32)).to(dev)
    g = torch.from_numpy(rng.standard_normal((m, feat), dtype=np.float32)).to(dev)
    table = torch.zeros((h * w, feat), dtype=torch.bfloat16, device=dev)
    gen = torch.Generator(device=dev).manual_seed(31)
    for rows in pk.corner_rows(rowid, h=h, w=w):
        table[rows] = torch.randn((m, feat), generator=gen, device=dev).to(
            torch.bfloat16)
    try:
        got = pk.bilerp_fwd_unpacked([table], [rowid], [tx], ty, h=h, w=w)
        want = pk.bilerp_fwd_unpacked_plain([table], [rowid], [tx], ty, h=h, w=w)
        (d_tx,), d_ty = pk.bilerp_bwd_coords([table], [g], [rowid], [tx], ty,
                                             h=h, w=w)
        (want_tx,), want_ty = pk.bilerp_bwd_coords_plain([table], [g], [rowid],
                                                         [tx], ty, h=h, w=w)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0])
        scale = max(float(want_tx.abs().max()), float(want_ty.abs().max()))
        assert float((d_tx - want_tx).abs().max()) <= 1e-5 * scale
        assert float((d_ty - want_ty).abs().max()) <= 1e-5 * scale
    finally:
        del table
        torch.cuda.empty_cache()


def test_row_divisor_constants_of_both_libraries(dev):
    """The constants the kernels' host code divides row ids by w with
    (snt_row_divisor of each library) are row_divisor's, which
    tests/test_torch_plane_coords.py holds exact: every w up to 4096, a
    seeded sample above it, and the largest."""
    import ctypes

    from soccernerfs_tpu_torch.ops.kernels import build

    rng = np.random.default_rng(5)
    ws = [*range(1, 4097), *rng.integers(4097, 2 ** 31, 2000).tolist(), 2 ** 31 - 1]
    magic, shift = ctypes.c_uint(), ctypes.c_uint()
    for lib in pk.LIBRARIES:
        fn = build.load(lib).snt_row_divisor
        fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_uint),
                       ctypes.POINTER(ctypes.c_uint)]
        fn.restype = None
        for w in ws:
            fn(w, ctypes.byref(magic), ctypes.byref(shift))
            assert (magic.value, shift.value) == pk.row_divisor(w), (lib, w)


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
    g8 = torch.zeros((5, 8), device=dev)
    with pytest.raises(ValueError):      # f32 table
        pk.bilerp_bwd_coords([table.float()], [g8], [z], [f], f, h=3, w=4)
    with pytest.raises(ValueError):      # neither layout of F = 8
        pk.bilerp_bwd_coords([table[:, :16].contiguous()], [g8], [z], [f], f,
                             h=3, w=4)
    with pytest.raises(ValueError):      # gradient rows != points
        pk.bilerp_bwd_coords([table], [g8[:4]], [z], [f], f, h=3, w=4)


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


# ---------------------------------------------------------------------------
# the importance sampler: cdf_scan_f64, cdf_draw
# ---------------------------------------------------------------------------


def _ist_maps(rng, n, size):
    """IST-like f16 maps: ~90 % zeros, the rest in (0.15, 1]."""
    maps = rng.uniform(0.15, 1.0, (n, size)).astype(np.float16)
    maps[rng.random((n, size)) < 0.9] = 0
    return maps


# the scan's boundaries: a thread's 16 cells, a CTA's 8,192, a cluster
# tile of 16 CTAs (131,072), each +- 1 (scalar loads: the rows are not
# 16-byte aligned) and +- 8 (vector loads), a 540 x 960 and a 1080 x 1920 map
SCAN_SIZES = [1, 15, 16, 17, 31, 1000, 8184, 8191, 8192, 8193, 8200, 16384,
              16385, 131064, 131071, 131072, 131073, 131080, 540 * 960,
              1080 * 1920]


@pytest.mark.parametrize("size", SCAN_SIZES)
def test_cdf_scan_matches_plain_f16(dev, size):
    """Every partial sum of an f16 map in [0, 1] is exact in f64, so the
    card's order of adds gives the sequential CDF bit for bit."""
    rng = np.random.default_rng(size)
    maps = torch.from_numpy(_ist_maps(rng, 5, size)).to(dev)
    ids = torch.tensor([3, 0, 4, 3], dtype=torch.int64, device=dev)
    before = spk.cdf_scan_f64.launches
    got = spk.cdf_scan_f64(maps, ids)
    want = spk.cdf_scan_f64_plain(maps.cpu(), ids.cpu())
    torch.cuda.synchronize()
    assert spk.cdf_scan_f64.launches == before + 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("size", [1000, 8193, 16385, 131072, 131073,
                                  540 * 960, 1080 * 1920])
def test_cdf_scan_f32_is_non_decreasing(dev, size):
    """f32 weights over many octaves round in the card's order: within
    1e-10 of the sequential sum (518,400 sequential f64 adds may stray by
    up to ~6e-11 of the sum), and no step decreases."""
    rng = np.random.default_rng(size)
    w = (rng.random((2, size)) * 10.0 ** rng.integers(-6, 6, (2, size))
         ).astype(np.float32)
    w[:, ::7] = 0
    maps = torch.from_numpy(w).to(dev)
    ids = torch.tensor([1, 0], dtype=torch.int64, device=dev)
    got = spk.cdf_scan_f64(maps, ids).cpu()
    want = spk.cdf_scan_f64_plain(maps.cpu(), ids.cpu())
    assert (got[:, 1:] >= got[:, :-1]).all()
    torch.testing.assert_close(got, want, rtol=1e-10, atol=0)


@pytest.mark.parametrize("maps,size", [(1, 540 * 960), (9, 540 * 960),
                                       (140, 100_003), (140, 100_000)])
def test_cdf_scan_many_maps_in_one_launch(dev, maps, size):
    """1 map (one cluster of 16 CTAs), a step's 9 and 140 (one CTA each),
    rows in any order and repeated: each bit-equal to the sequential sum."""
    rng = np.random.default_rng(maps)
    weights = torch.from_numpy(_ist_maps(rng, min(maps, 20), size)).to(dev)
    ids = torch.from_numpy(rng.integers(0, weights.shape[0], maps)).to(dev)
    got = spk.cdf_scan_f64(weights, ids)
    want = spk.cdf_scan_f64_plain(weights.cpu(), ids.cpu())
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("half", [True, False])
def test_cdf_scan_unaligned_rows(dev, half):
    """Maps whose data starts 8 bytes past a 16-byte boundary take the
    scalar loads: the same CDF."""
    rng = np.random.default_rng(5)
    size = 540 * 960
    dtype = torch.float16 if half else torch.float32
    flat = torch.zeros(3 * size + 8, dtype=dtype, device=dev)
    shift = 8 // flat.element_size()
    maps = flat[shift:shift + 3 * size].view(3, size)
    maps.copy_(torch.from_numpy(_ist_maps(rng, 3, size)).to(dev, dtype))
    assert maps.data_ptr() % 16 == 8
    ids = torch.tensor([2, 0, 1], dtype=torch.int64, device=dev)
    got = spk.cdf_scan_f64(maps, ids)
    want = spk.cdf_scan_f64_plain(maps.cpu(), ids.cpu())
    assert torch.equal(got.cpu(), want)


def _plan(ks, reps):
    counts = [spk.draw_count(k, r) for k, r in zip(ks, reps)]
    uni_off = np.concatenate([[0], np.cumsum(counts)[:-1]])
    out_off = np.concatenate([[0], np.cumsum(ks)[:-1]])
    plan = np.stack([uni_off, ks, np.asarray(reps, np.int64), out_off], 1)
    return torch.from_numpy(plan.astype(np.int64)), int(sum(counts))


def test_cdf_draw_matches_plain(dev):
    """The same CDFs and uniforms: the same indices, with and without
    replacement, a spent budget (3 cells at k = 5), a single cell, k = 0
    and a uniform of 0."""
    rng = np.random.default_rng(0)
    size = 540 * 960
    maps = _ist_maps(rng, 6, size)
    maps[3] = 0
    maps[3, [5, 7000, size - 1]] = [0.5, 1.0, 0.25]     # support 3
    maps[4] = 0
    maps[4, 12345] = 1.0                                # one cell
    ks = [20, 20, 2, 5, 3, 0, 122]
    reps = [False, True, False, False, False, False, False]
    ids = torch.tensor([0, 1, 2, 3, 4, 5, 5], dtype=torch.int64, device=dev)
    cdf = spk.cdf_scan_f64(torch.from_numpy(maps).to(dev), ids)
    plan, n = _plan(ks, reps)
    uni = rng.random(n)
    uni[0] = 0.0
    uniforms = torch.from_numpy(uni).to(dev)
    before = spk.cdf_draw.launches
    got = spk.cdf_draw(cdf, uniforms, plan.to(dev), sum(ks)).cpu()
    want = spk.cdf_draw_plain(cdf.cpu(), uniforms.cpu(), plan, sum(ks))
    torch.cuda.synchronize()
    assert spk.cdf_draw.launches == before + 1
    assert torch.equal(got, want)
    kept = got.numpy()
    assert len(set(kept[:20].tolist())) == 20
    assert set(kept[42:47].tolist()) == {5, 7000, size - 1}
    assert (kept[47:50] == 12345).all()


def _draws_match_plain(dev, maps, ks, reps, uni=None, seed=0):
    """The card's draws from the card's CDFs of ``maps`` [M, S] (numpy)
    against the plain version on the same CDFs; returns the draws."""
    rng = np.random.default_rng(seed)
    ids = torch.arange(len(maps), dtype=torch.int64, device=dev)
    cdf = spk.cdf_scan_f64(torch.from_numpy(maps).to(dev), ids)
    plan, n = _plan(ks, reps)
    if uni is None:
        uni = rng.random(n)
    uniforms = torch.from_numpy(uni).to(dev)
    got = spk.cdf_draw(cdf, uniforms, plan.to(dev), sum(ks)).cpu()
    want = spk.cdf_draw_plain(cdf.cpu(), uniforms.cpu(), plan, sum(ks))
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    return got.numpy()


def test_cdf_draw_window_edges(dev):
    """Searches at the coarse index's seams (540 x 960: windows of 127
    cells): support only in the last window; a plateau of zeros across
    three window boundaries hit exactly at its value (the first cell that
    reaches it), just above it, and at 0; a uniform of 0 and the largest
    double below 1."""
    size = 540 * 960
    last = np.zeros(size, np.float16)
    last[[size - 3, size - 1]] = [0.5, 0.25]        # the last window only
    plateau = np.zeros(size, np.float16)
    plateau[:100] = 0.5                             # CDF 50 at cell 99,
    plateau[400:556] = 0.5                          # zeros 100-399, total 128
    lead = np.zeros(size, np.float16)
    lead[300::7] = 1.0                              # zeros over 3 windows
    below_one = np.nextafter(1.0, 0.0)
    above = np.nextafter(50 / 128, 1.0)
    uni = np.concatenate([
        [1e-12, below_one, 0.5, 0.7, 0.75, 2 / 3],
        [0.0, below_one, 50 / 128, above], np.full(96, 0.9),
        [50 / 128, above, 0.0, below_one, 0.0],
        [0.0, below_one, 1e-9, 0.5, 0.0],
    ])
    got = _draws_match_plain(dev, np.stack([last, plateau, plateau, lead]),
                             [6, 4, 5, 5], [True, False, True, True], uni)
    assert set(got[:6].tolist()) <= {size - 3, size - 1}
    assert got[6:10].tolist() == [0, 555, 99, 400]
    assert got[10:15].tolist() == [99, 400, 0, 555, 0]
    assert got[15:20].tolist()[:3] == [0, np.flatnonzero(lead)[-1], 300]
    assert got[19] == 0


@pytest.mark.parametrize("size", [1, 7, 4095, 4097, 540 * 960, 1080 * 1920])
def test_cdf_draw_sizes(dev, size):
    """Maps smaller than the coarse index (one cell a window), one window
    more or less than it, a step's and a full HD map's (507-cell windows:
    four 128-cell chunks a window)."""
    rng = np.random.default_rng(size)
    maps = _ist_maps(rng, 3, size)
    maps[:, -1] = 0.5                               # no all-zero map
    _draws_match_plain(dev, maps, [70, 70, 20], [size < 80, True, False])


@pytest.mark.parametrize("k", [0, 3, 4, 40])
def test_cdf_draw_budget(dev, k):
    """A map of 3 cells: k = 3 keeps all three within the 8k + 64
    attempts, k = 4 and 40 spend the budget and fill with replacement, k = 0
    draws nothing (with and without replacement)."""
    size = 540 * 960
    maps = np.zeros((2, size), np.float16)
    maps[:, [5, size // 2, size - 1]] = [0.5, 1.0, 0.25]
    got = _draws_match_plain(dev, maps, [k, k], [False, True], seed=k)
    if k:
        assert set(got[:min(k, 3)].tolist()) == {5, size // 2, size - 1}


def test_cdf_draw_large_k(dev):
    """k past the kept indices held in shared memory (2,048) and rounds of
    1,024 attempts: 3,000 without replacement from 50,000 cells (the walk
    reads the later kept indices back from the output), 5,000 with; and a
    support barely above k (many rejections, rounds that double)."""
    rng = np.random.default_rng(3)
    size = 540 * 960
    maps = np.zeros((3, size), np.float16)
    maps[0, rng.choice(size, 50_000, replace=False)] = 0.75
    maps[1] = _ist_maps(rng, 1, size)[0]
    maps[2, rng.choice(size, 75, replace=False)] = 0.5
    got = _draws_match_plain(dev, maps, [3000, 5000, 70], [False, True, False])
    assert len(set(got[:3000].tolist())) == 3000
    assert len(set(got[8000:].tolist())) == 70


def test_weighted_samples_on_the_card_match_the_cpu(dev):
    """The sampler's call on card tensors and on CPU tensors: equal draws
    (f16 IST maps: the card's CDF is the sequential one)."""
    from soccernerfs_tpu_torch.data import native_loader

    rng = np.random.default_rng(1)
    maps = torch.from_numpy(_ist_maps(rng, 95, 540 * 960))
    ids = [int(i) for i in rng.choice(95, 9, replace=False)]
    ks, reps = [70] * 8 + [54], [False] * 9      # 614 IST rays of 4096
    seeds = [int(s) for s in rng.integers(0, 2**62, 9)]
    got = native_loader.weighted_samples(maps.to(dev), ids, ks, reps, seeds)
    want = native_loader.weighted_samples(maps, ids, ks, reps, seeds)
    np.testing.assert_array_equal(got, want)
