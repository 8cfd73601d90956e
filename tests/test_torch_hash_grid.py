"""The port's static hash-grid encoder (soccernerfs_tpu_torch/ops/hash_grid.py)
and the plain version of its scatter kernel against the JAX package on the
CPU: row indices exactly, values, table gradients and position gradients
at stated tolerances, for the xor, zline and tiled configs, dense and
hashed levels.  Inputs are made with numpy from a seed.

JAX runs two ways: its default CPU path (f32 gathers, ``jnp.take``'s
transpose), which computes what the port computes, and its TPU path in
Pallas interpret mode (``SCATTER_INTERPRET``, set by monkeypatch as the JAX
package's own tests do), which gathers hashed zline levels from a bf16
table and scatters bf16 updates.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from soccernerfs_tpu.ops import hash_grid as jh
from soccernerfs_tpu.ops.pallas import plane_kernels as jpk
from soccernerfs_tpu_torch.ops import hash_grid as th
from soccernerfs_tpu_torch.ops.kernels import scatter_kernels as sk


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


# levels 0-1 dense (4^3, 7^3 cells), 2-5 oversubscribed at 2^10 rows
SMALL = dict(num_levels=6, level_dim=2, base_resolution=4,
             desired_resolution=64, log2_hashmap_size=10)
CONFIGS = {
    "xor": dict(SMALL, hash_scheme="xor"),
    "zline": dict(SMALL, hash_scheme="zline"),
    "tiled": dict(SMALL, gridtype="tiled"),
    "xor4": dict(SMALL, hash_scheme="xor", level_dim=4, num_levels=3),
}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _rel(got, want) -> float:
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


@pytest.mark.parametrize("name", ["xor", "zline", "tiled"])
def test_level_layout_matches_jax(name):
    """Offsets, scales and resolutions, exactly; at the registered nerfacto
    widths too (16 levels to 2048 at 2^19 rows: 5 dense levels, 6,098,120
    rows; proposal grids of 5 levels to 128 and 256 at 2^17)."""
    for kw in (CONFIGS[name],
               dict(num_levels=16, desired_resolution=2048, hash_scheme="zline"),
               dict(num_levels=5, desired_resolution=128, log2_hashmap_size=17),
               dict(num_levels=5, desired_resolution=256, log2_hashmap_size=17)):
        jc, tc = jh.HashGridConfig(**kw), th.HashGridConfig(**kw)
        assert th.level_layout(tc) == jh.level_layout(jc)
        assert (jc.scale, jc.output_dim, jc.row_channels) == (
            tc.scale, tc.output_dim, tc.row_channels)
    main = th.HashGridConfig(num_levels=16, desired_resolution=2048)
    assert th.level_layout(main)[0][-1] == 6_098_120
    assert sum(th.strided_levels(main)) == 5


@pytest.mark.parametrize("strided", [True, False])
@pytest.mark.parametrize("name", ["xor", "zline", "tiled"])
def test_hash_index_equals_jax(name, strided):
    """Row indices of random lattice coordinates in [0, 4100)^3 (uint32
    products wrap from ~2 on), per level kind and hash scheme, against
    ``_hash_index``: equal, every one."""
    kw = CONFIGS[name]
    jc, tc = jh.HashGridConfig(**kw), th.HashGridConfig(**kw)
    rng = np.random.default_rng(1)
    coords = rng.integers(0, 4100, (4000, 3)).astype(np.int32)
    coords[:8] = [[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1], [4099] * 3,
                  [2048, 2047, 2049], [1, 1, 1], [15, 16, 17]]
    for resolution, rows in ((7, 344), (23, 12168), (300, 1 << 10), (2048, 1 << 19)):
        dense = strided and name != "tiled"
        if name != "tiled" and not strided and resolution**3 <= rows:
            continue
        if name == "tiled" and not strided:
            continue    # a tiled grid has no hashed level
        want = np.asarray(jh._hash_index(jnp.asarray(coords), resolution, rows,
                                         jc, dense))
        per_dim = [_t(coords[:, d].astype(np.int64))[None, None] for d in range(3)]
        got = th.hash_index(per_dim, torch.tensor([[[resolution]]]),
                            torch.tensor([[[rows]]]), tc, strided)
        assert got.shape == (1, 1, 4000)
        np.testing.assert_array_equal(got[0, 0].numpy(), want)
        assert want.min() >= 0 and want.max() < rows


@pytest.mark.parametrize("name", ["xor", "zline", "tiled"])
def test_grid_corners_match_jax_per_level(name):
    """The encoder's own corner rows and weights on every level against
    the JAX package's per-corner construction (``_hash_index`` of
    ``floor(pos) + offset``), x = 0 and x = 1 included: rows equal, weights
    to 1e-6."""
    kw = CONFIGS[name]
    jc, tc = jh.HashGridConfig(**kw), th.HashGridConfig(**kw)
    offsets, scales, resolutions = jh.level_layout(jc)
    rng = np.random.default_rng(2)
    x = rng.uniform(0, 1, (300, 3)).astype(np.float32)
    x[0], x[1], x[2] = 0.0, 1.0, [0.0, 1.0, 0.5]
    idxs, ws = th.grid_corners(tc, _t(x))
    assert idxs.dtype == torch.int32 and idxs.shape == (jc.num_levels, 8, 300)
    corner_offsets = np.stack(np.meshgrid(*([np.arange(2)] * 3), indexing="ij"),
                              -1).reshape(-1, 3)
    for lvl in range(jc.num_levels):
        rows = offsets[lvl + 1] - offsets[lvl]
        dense = resolutions[lvl] ** 3 <= rows
        pos = jnp.asarray(x) * scales[lvl] + 0.5
        pos0 = jnp.floor(pos)
        frac = np.asarray(pos - pos0)
        for c, off in enumerate(corner_offsets):
            want = np.asarray(jh._hash_index(pos0.astype(jnp.int32) + off,
                                             resolutions[lvl], rows, jc, dense))
            np.testing.assert_array_equal(idxs[lvl, c].numpy(),
                                          want + offsets[lvl])
            w = np.prod(np.where(off[None] == 1, frac, 1.0 - frac), axis=-1)
            np.testing.assert_allclose(ws[lvl, c].numpy(), w, atol=1e-6)


def _encode_both(kw, x, table, cot):
    jc, tc = jh.HashGridConfig(**kw), th.HashGridConfig(**kw)

    def jloss(t, xx):
        return jnp.vdot(jh.hash_grid_encode(jc, {"embeddings": t}, xx), cot)

    jout = jh.hash_grid_encode(jc, {"embeddings": jnp.asarray(table)},
                               jnp.asarray(x))
    jgt, jgx = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(table), jnp.asarray(x))
    tt = _t(table).requires_grad_(True)
    tx = _t(x).requires_grad_(True)
    tout = th.hash_grid_encode(tc, {"embeddings": tt}, tx)
    (tout * _t(cot)).sum().backward()
    return (jout, jgt, jgx), (tout, tt.grad, tx.grad)


def _inputs(kw, seed, n=400):
    rng = np.random.default_rng(seed)
    rows = th.level_layout(th.HashGridConfig(**kw))[0][-1]
    table = rng.uniform(-0.5, 0.5, (rows, kw["level_dim"])).astype(np.float32)
    x = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    x[0], x[1] = 0.0, 1.0
    cot = rng.standard_normal((n, kw["num_levels"] * kw["level_dim"])
                              ).astype(np.float32)
    return x, table, cot


@pytest.mark.parametrize("name", list(CONFIGS))
def test_encode_matches_jax_cpu_path(name):
    """Values, table gradient and position gradient against JAX's default
    CPU path (f32 gathers), dense and hashed levels together.  Values 1e-6
    of the max (the same f32 products, summed over the corners in the same
    order); gradients 1e-5 of the max (f32 sums of colliding updates in
    another order)."""
    kw = CONFIGS[name]
    (jout, jgt, jgx), (tout, tgt, tgx) = _encode_both(kw, *_inputs(kw, 3))
    assert tout.shape == jout.shape
    assert _rel(tout, jout) <= 1e-6
    assert _rel(tgt, jgt) <= 1e-5
    assert _rel(tgx, jgx) <= 1e-5


@pytest.mark.parametrize("name", ["xor", "zline", "tiled"])
def test_encode_matches_jax_pallas_interpret_path(name, monkeypatch):
    """The same against JAX's TPU path run in Pallas interpret mode, which
    gathers hashed zline levels from a bf16 copy of the table and feeds
    ``sorted_scatter_add`` bf16 updates: values to 1e-2 of the max,
    gradients to 2e-2 (the bf16 tolerances of the JAX package's own
    tests).  The port gathers and adds in f32, so it sits at the exact end
    of that band."""
    monkeypatch.setattr(jh, "SCATTER_INTERPRET", True)
    kw = CONFIGS[name]
    (jout, jgt, jgx), (tout, tgt, tgx) = _encode_both(kw, *_inputs(kw, 4, n=150))
    assert _rel(tout, jout) <= 1e-2
    assert _rel(tgt, jgt) <= 2e-2
    assert _rel(tgx, jgx) <= 2e-2


# ---------------------------------------------------------------------------
# lattice coordinates outside the grid: a deformed point leaves the cube
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,strided", [("dense", True), ("xor", False),
                                          ("zline", False), ("tiled", True)])
def test_hash_index_equals_jax_outside_the_grid(name, strided):
    """Row indices of random lattice coordinates in [-70, 4100)^3, -1, 0
    and the resolution's edges among them, per level kind, against
    ``_hash_index``: equal, every one.  zline's truncating remainder makes
    negative rows where the last coordinate is negative (JAX's too)."""
    kw = CONFIGS["xor" if name == "dense" else name]
    jc, tc = jh.HashGridConfig(**kw), th.HashGridConfig(**kw)
    rng = np.random.default_rng(8)
    coords = rng.integers(-70, 4100, (6000, 3)).astype(np.int32)
    coords[:8] = [[-1, -1, -1], [-1, 0, 0], [0, -1, 0], [0, 0, -1], [-70] * 3,
                  [-70, 4099, -1], [300, -2, 301], [7, 23, -69]]
    negative = 0
    for resolution, rows in ((7, 344), (23, 12168), (300, 1 << 10),
                             (2048, 1 << 19)):
        if not strided and resolution**3 <= rows:
            continue
        want = np.asarray(jh._hash_index(jnp.asarray(coords), resolution, rows,
                                         jc, strided and name != "tiled"))
        per_dim = [_t(coords[:, d].astype(np.int64))[None, None] for d in range(3)]
        got = th.hash_index(per_dim, torch.tensor([[[resolution]]]),
                            torch.tensor([[[rows]]]), tc, strided)
        np.testing.assert_array_equal(got[0, 0].numpy(), want)
        assert want.max() < rows and want.min() > -rows
        negative += int((want < 0).sum())
    # only zline's rows go negative, and only by the last coordinate
    assert (negative > 0) == (name == "zline")


def _outside_inputs(kw, seed, n):
    """Points in [-0.1, 1.1]^3 (about half of them outside the cube), a
    table of U(-0.5, 0.5) and a cotangent."""
    rng = np.random.default_rng(seed)
    rows = th.level_layout(th.HashGridConfig(**kw))[0][-1]
    table = rng.uniform(-0.5, 0.5, (rows, kw["level_dim"])).astype(np.float32)
    x = rng.uniform(-0.1, 1.1, (n, 3)).astype(np.float32)
    cot = rng.standard_normal((n, kw["num_levels"] * kw["level_dim"])
                              ).astype(np.float32)
    return x, table, cot


def _negative_zline_rows(jc, x) -> np.ndarray:
    """[B] bool: the points with a corner whose zline row is negative on
    some hashed level (``_hash_index``, JAX's own rows)."""
    offsets, scales, resolutions = jh.level_layout(jc)
    out = np.zeros(x.shape[0], bool)
    for lvl, (scale, res) in enumerate(zip(scales, resolutions)):
        rows = offsets[lvl + 1] - offsets[lvl]
        if res**3 <= rows:
            continue
        base = np.floor(x * scale + 0.5).astype(np.int32)
        for off in np.stack(np.meshgrid(*([np.arange(2)] * 3), indexing="ij"),
                            -1).reshape(-1, 3):
            r = np.asarray(jh._hash_index(jnp.asarray(base + off), res, rows,
                                          jc, False))
            out |= r < 0
    return out


@pytest.mark.parametrize("path", ["cpu", "pallas_interpret"])
def test_encode_outside_the_cube_matches_jax(path, monkeypatch):
    """The decomposition field's static grid (zline, per-level scale
    1.4473, 16 levels, here at 2^12 rows: level 0 dense, the rest hashed)
    at points in [-0.1, 1.1]^3, as the deformed encode sees them: values,
    table gradient and position gradient.

    Against JAX's CPU path, every point, at that path's tolerances (values
    1e-6 of the max, gradients 1e-5): the port reads a negative zline row
    where that path's ``jnp.take`` reads it, from the whole table.  Against
    the Pallas-interpret path at its bf16 tolerances (1e-2, 2e-2), every
    point with no negative zline row, outside the cube or not.  The points
    with one are held apart: there the JAX package's two paths disagree
    with each other (the TPU path clamps the row to its level's first in
    the forward and drops its updates in the backward), which the test
    shows; the port keeps the CPU path's, whose gradient is the transpose
    of its forward."""
    from soccernerfs_tpu.fields import nerfplayer as jnf

    jc = jnf.NerfplayerFieldConfig(log2_hashmap_size=12).static_grid
    kw = {k: getattr(jc, k) for k in ("num_levels", "level_dim",
                                      "base_resolution", "per_level_scale",
                                      "log2_hashmap_size", "hash_scheme")}
    assert kw["hash_scheme"] == "zline" and kw["num_levels"] == 16
    x, table, cot = _outside_inputs(kw, 9, 400)
    outside = ~np.all((x >= 0) & (x <= 1), axis=1)
    assert outside.mean() > 0.3
    held_apart = _negative_zline_rows(jc, x)
    if path == "cpu":
        (jout, jgt, jgx), (tout, tgt, tgx) = _encode_both(kw, x, table, cot)
        assert held_apart.any()
        assert _rel(tout, jout) <= 1e-6
        assert _rel(tgt, jgt) <= 1e-5
        assert _rel(tgx, jgx) <= 1e-5
        return
    monkeypatch.setattr(jh, "SCATTER_INTERPRET", True)
    assert 0 < held_apart.sum() < 0.1 * len(x)
    keep = ~held_apart
    assert (keep & outside).sum() > 0.25 * len(x)
    (jout, jgt, jgx), (tout, tgt, tgx) = _encode_both(kw, x[keep], table,
                                                      cot[keep])
    assert _rel(tout, jout) <= 1e-2
    assert _rel(tgt, jgt) <= 2e-2
    assert _rel(tgx, jgx) <= 2e-2
    # the points held apart: the JAX package's TPU path against its own
    # CPU path
    apart = jnp.asarray(x[held_apart])
    tpu_path = np.asarray(jh.hash_grid_encode(jc, {"embeddings": jnp.asarray(table)},
                                              apart))
    monkeypatch.setattr(jh, "SCATTER_INTERPRET", False)
    cpu_path = np.asarray(jh.hash_grid_encode(jc, {"embeddings": jnp.asarray(table)},
                                              apart))
    assert _rel(tpu_path, cpu_path) > 2e-2


def test_encode_without_position_gradient_skips_the_weight_gradient():
    """Positions that do not require grad: the table gradient is the same
    and no gradient comes back for the weights (autograd's own
    bookkeeping, where the JAX package has an ``input_grads`` flag)."""
    kw = CONFIGS["zline"]
    x, table, cot = _inputs(kw, 5)
    tc = th.HashGridConfig(**kw)
    grads = []
    for needs in (True, False):
        tt = _t(table).requires_grad_(True)
        tx = _t(x).requires_grad_(needs)
        (th.hash_grid_encode(tc, {"embeddings": tt}, tx) * _t(cot)).sum().backward()
        grads.append(tt.grad)
        assert (tx.grad is not None) == needs
    torch.testing.assert_close(grads[0], grads[1], rtol=0, atol=0)
    with torch.no_grad():
        out = th.hash_grid_encode(tc, {"embeddings": _t(table)}, _t(x))
    assert out.shape == (x.shape[0], tc.output_dim) and not out.requires_grad


def test_init_hash_grid_draws_every_row_channel():
    """U(-1e-4, 1e-4) over [rows, level_dim + temporal_dim], static and
    temporal."""
    for kw in (CONFIGS["xor"], TEMPORAL["xor"]):
        cfg = th.HashGridConfig(**kw)
        table = th.init_hash_grid(cfg, torch.Generator().manual_seed(0))["embeddings"]
        assert table.shape == (th.level_layout(cfg)[0][-1], cfg.row_channels)
        assert float(table.abs().max()) <= 1e-4


# ---------------------------------------------------------------------------
# temporal grids
# ---------------------------------------------------------------------------

# 3 levels: level 0 dense (4^3), 1-2 oversubscribed at 2^10 rows; 8 temporal
# channels (10 per row), and 5 with 3 features per level
TEMPORAL = {
    "xor": dict(SMALL, num_levels=3, temporal_dim=8, hash_scheme="xor"),
    "zline": dict(SMALL, num_levels=3, temporal_dim=8, hash_scheme="zline"),
    "xor3": dict(SMALL, num_levels=3, level_dim=3, temporal_dim=5),
}
# the registered nerfplayer-nerfacto grids: main field, proposal_0, proposal_1
REGISTERED_TEMPORAL = (
    dict(temporal_dim=64, num_levels=16, desired_resolution=1024),
    dict(temporal_dim=32, num_levels=5, desired_resolution=64,
         log2_hashmap_size=17, hash_scheme="zline"),
    dict(temporal_dim=32, num_levels=5, desired_resolution=256,
         log2_hashmap_size=17, hash_scheme="zline"),
)


@pytest.mark.parametrize("kw", [*TEMPORAL.values(), *REGISTERED_TEMPORAL],
                         ids=[*TEMPORAL, "main", "proposal_0", "proposal_1"])
def test_temporal_tables_equal_jax(kw):
    """sampling_index, both masks and index_list, exactly, with their
    types; the channel picks, held as f32, are whole numbers below the
    row's channels."""
    jc, tc = jh.HashGridConfig(**kw), th.HashGridConfig(**kw)
    got, want = th.temporal_tables(tc), jh.temporal_tables(jc)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    picks = got[0].reshape(got[0].shape[0], -1, 4)[..., 1::2]
    assert np.array_equal(picks, np.round(picks)) and picks.max() < tc.row_channels


@pytest.mark.parametrize("name", list(TEMPORAL))
def test_temporal_index_equals_jax(name):
    """get_temporal_index and get_temporal_row on random times, 0, 1 and
    the temporal rows' edges, exactly (the same f32 arithmetic)."""
    kw = TEMPORAL[name]
    jc, tc = jh.HashGridConfig(**kw), th.HashGridConfig(**kw)
    rng = np.random.default_rng(6)
    n_rows = tc.temporal_dim - 1
    t = np.concatenate([rng.uniform(0, 1, 500), [0.0, 1.0],
                        np.arange(n_rows) / (n_rows - 1)]).astype(np.float32)
    np.testing.assert_array_equal(
        th.get_temporal_index(tc, _t(t)).numpy(),
        np.asarray(jh.get_temporal_index(jc, jnp.asarray(t))))
    np.testing.assert_array_equal(
        th.get_temporal_row(tc, _t(t)).numpy(),
        np.asarray(jh.get_temporal_row(jc, jnp.asarray(t))))


def _temporal_inputs(kw, seed, n=300):
    rng = np.random.default_rng(seed)
    cfg = th.HashGridConfig(**kw)
    rows = th.level_layout(cfg)[0][-1]
    table = rng.uniform(-0.5, 0.5, (rows, cfg.row_channels)).astype(np.float32)
    x = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    x[0], x[1] = 0.0, 1.0
    t = rng.uniform(0, 1, n).astype(np.float32)
    t[:3] = [0.0, 1.0, 0.5]
    cot = rng.standard_normal((n, cfg.output_dim)).astype(np.float32)
    return x, t, table, cot


def _temporal_encode_both(kw, x, t, table, cot):
    """(values, table gradient) of JAX's encode and the port's."""
    jc, tc = jh.HashGridConfig(**kw), th.HashGridConfig(**kw)

    def jloss(tab):
        return jnp.vdot(jh.hash_grid_encode(jc, {"embeddings": tab},
                                            jnp.asarray(x), jnp.asarray(t)), cot)

    jout = jh.hash_grid_encode(jc, {"embeddings": jnp.asarray(table)},
                               jnp.asarray(x), jnp.asarray(t))
    jgt = jax.grad(jloss)(jnp.asarray(table))
    tt = _t(table).requires_grad_(True)
    tout = th.hash_grid_encode(tc, {"embeddings": tt}, _t(x), _t(t))
    (tout * _t(cot)).sum().backward()
    return (jout, jgt), (tout, tt.grad)


@pytest.mark.parametrize("name", list(TEMPORAL))
def test_temporal_encode_matches_jax_cpu_path(name):
    """Values and table gradient against JAX's default CPU path (f32
    gathers, the corner sum in row space, then the window pick), dense and
    hashed levels together, f32 at rtol 1e-5 of the max: the values are
    the same f32 products summed in the same order; the gradient sums
    colliding updates in another order."""
    kw = TEMPORAL[name]
    (jout, jgt), (tout, tgt) = _temporal_encode_both(kw, *_temporal_inputs(kw, 7))
    assert tout.shape == jout.shape == (300, kw["num_levels"] * kw["level_dim"])
    assert _rel(tout, jout) <= 1e-5
    assert _rel(tgt, jgt) <= 1e-5


@pytest.mark.parametrize("name", ["xor", "zline"])
def test_temporal_encode_matches_jax_pallas_interpret_path(name, monkeypatch):
    """The same against JAX's TPU path run in Pallas interpret mode, which
    gathers bf16 rows and feeds ``sorted_scatter_add`` bf16 updates on
    temporal-row keys: values to 1e-2 of the max, gradients to 2e-2 (the
    bf16 tolerances of the JAX package's own tests)."""
    monkeypatch.setattr(jh, "SCATTER_INTERPRET", True)
    kw = TEMPORAL[name]
    (jout, jgt), (tout, tgt) = _temporal_encode_both(
        kw, *_temporal_inputs(kw, 8, n=120))
    assert _rel(tout, jout) <= 1e-2
    assert _rel(tgt, jgt) <= 2e-2


def test_temporal_scatter_plain_matches_dense_transpose():
    """The encode's table gradient (width-1 scatter_add_rows' plain version
    over the flattened table, one group per level and picked entry)
    against the dense transpose built entry by entry in f64 with
    ``np.add.at``: 1e-6 of the max; and the encode's values against the
    same picks read in f64."""
    kw = TEMPORAL["zline"]
    cfg = th.HashGridConfig(**kw)
    x, t, table, cot = _temporal_inputs(kw, 9, n=200)
    idxs, ws = th.grid_corners(cfg, _t(x))
    tri = th.get_temporal_index(cfg, _t(t)).view(len(t), cfg.level_dim, 4).numpy()
    w, ch = tri[..., 0::2].astype(np.float64), tri[..., 1::2].astype(np.int64)
    idxs, ws = idxs.numpy().astype(np.int64), ws.numpy().astype(np.float64)
    levels, corners, points = idxs.shape
    want = np.zeros(table.size)
    value = np.zeros((points, levels, cfg.level_dim))
    g = cot.reshape(points, levels, cfg.level_dim).astype(np.float64)
    flat = table.reshape(-1).astype(np.float64)
    for lvl in range(levels):
        for k in range(corners):
            for i in range(cfg.level_dim):
                for s in range(2):
                    entry = idxs[lvl, k] * cfg.row_channels + ch[:, i, s]
                    coef = ws[lvl, k] * w[:, i, s]
                    np.add.at(want, entry, coef * g[:, lvl, i])
                    value[:, lvl, i] += coef * flat[entry]
    tt = _t(table).requires_grad_(True)
    out = th.hash_grid_encode(cfg, {"embeddings": tt}, _t(x), _t(t))
    (out * _t(cot)).sum().backward()
    assert _rel(out, value.reshape(points, -1)) <= 1e-6
    assert _rel(tt.grad.reshape(-1), want) <= 1e-6


def test_temporal_out_of_range_index_raises(monkeypatch):
    """A corner row outside the table: the encode's gather and its
    width-1 scatter (the flat index ``row * C_row + channel``, formed in
    int64 and clamped before the int32 cast, so no product wraps into
    range) both raise IndexError on the CPU."""
    kw = TEMPORAL["xor"]
    cfg = th.HashGridConfig(**kw)
    x, t, table, cot = _temporal_inputs(kw, 10, n=50)
    rows = table.shape[0]
    corners = th.grid_corners

    def bad(gcfg, xyz):
        idxs, ws = corners(gcfg, xyz)
        idxs[1, 3, 7] = rows
        return idxs, ws

    monkeypatch.setattr(th, "grid_corners", bad)
    with pytest.raises(IndexError):
        th.hash_grid_encode(cfg, {"embeddings": _t(table)}, _t(x), _t(t))
    monkeypatch.setattr(th, "grid_corners", corners)
    idxs, ws = th.grid_corners(cfg, _t(x))
    ch = torch.zeros((4, 50), dtype=torch.long)
    for row in (rows, -1, 2**31 - 1, 2**31 // cfg.row_channels + 1):
        flat = th._picked_entries(torch.full_like(idxs, row), ch,
                                  cfg.row_channels, rows).to(torch.int32)
        assert bool(((flat < 0) | (flat >= table.size)).all())
        with pytest.raises(IndexError):
            sk.scatter_add_rows(torch.ones((50, flat.shape[0] * 4)),
                                flat.view(-1, 8, 50), rows=table.size)


def _temporal_input_grads(kw, x, t, table, cot, input_grads=True):
    """(position, time) gradients of <encode, cot>: JAX's
    ``hash_grid_encode(..., input_grads=...)`` on its CPU path, and the
    port's."""
    jc, tc = jh.HashGridConfig(**kw), th.HashGridConfig(**kw)

    def jloss(xx, tt):
        return jnp.vdot(jh.hash_grid_encode(
            jc, {"embeddings": jnp.asarray(table)}, xx, tt,
            input_grads=input_grads), cot)

    jgx, jgt = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(t))
    tx = _t(x).requires_grad_(True)
    tt = _t(t).requires_grad_(True)
    out = th.hash_grid_encode(tc, {"embeddings": _t(table).requires_grad_(True)},
                              tx, tt, input_grads=input_grads)
    if not input_grads:
        assert not out.requires_grad or out.grad_fn is not None
        (out * _t(cot)).sum().backward()
        return (jgx, jgt), (tx.grad, tt.grad)
    gx, gt = torch.autograd.grad((out * _t(cot)).sum(), (tx, tt))
    return (jgx, jgt), (gx, gt)


def test_temporal_inputs_that_need_a_gradient_are_refused():
    """Positions and times that need a gradient get it (the refusal this
    test once held is gone): against jax.grad of JAX's
    ``hash_grid_encode(..., input_grads=True)`` on its CPU path, every
    temporal config (dense and hashed levels, xor and zline, level_dim 2
    and 3), positions and times at rtol 1e-5 of the max (the same f32
    products; the per-corner and per-level sums in another order).  With
    ``input_grads=False`` both are detached, as JAX's stop_gradient: no
    gradient reaches them.  The refusals that stay: a temporal grid needs
    times, a static one takes none; temporal_dim 1 has no window."""
    for name, kw in TEMPORAL.items():
        x, t, table, cot = _temporal_inputs(kw, 11, n=60)
        (jgx, jgt), (gx, gt) = _temporal_input_grads(kw, x, t, table, cot)
        assert gx.shape == (60, 3) and gt.shape == (60,)
        assert float(np.abs(np.asarray(jgx)).max()) > 0, name
        assert float(np.abs(np.asarray(jgt)).max()) > 0, name
        assert _rel(gx, jgx) <= 1e-5, (name, _rel(gx, jgx))
        assert _rel(gt, jgt) <= 1e-5, (name, _rel(gt, jgt))
        (jgx, jgt), (gx, gt) = _temporal_input_grads(kw, x, t, table, cot,
                                                     input_grads=False)
        assert gx is None and gt is None
        assert not np.asarray(jgx).any() and not np.asarray(jgt).any()
    kw = TEMPORAL["xor"]
    cfg = th.HashGridConfig(**kw)
    x, t, table, _cot = _temporal_inputs(kw, 11, n=10)
    params = {"embeddings": _t(table)}
    with pytest.raises(ValueError):
        th.hash_grid_encode(cfg, params, _t(x))
    with pytest.raises(ValueError):
        th.hash_grid_encode(th.HashGridConfig(**CONFIGS["xor"]),
                            {"embeddings": torch.zeros(10, 2)}, _t(x), _t(t))
    with pytest.raises(ValueError):
        th.init_hash_grid(th.HashGridConfig(temporal_dim=1))


@pytest.mark.parametrize("index", range(len(REGISTERED_TEMPORAL)))
def test_temporal_input_grads_at_registered_widths_match_jax(index):
    """The position and time gradients on the registered nerfplayer-nerfacto
    grids' widths (64 and 32 temporal channels, 16 and 5 levels, xor and
    zline; 2^15 rows a level, to keep the CPU's tables small) against JAX's
    CPU path, rtol 1e-5 of the max, and a table gradient unchanged by
    asking for them (the width-1 scatter, bit for bit)."""
    kw = dict(REGISTERED_TEMPORAL[index], log2_hashmap_size=15)
    x, t, table, cot = _temporal_inputs(kw, 20 + index, n=80)
    (jgx, jgt), (gx, gt) = _temporal_input_grads(kw, x, t, table, cot)
    assert _rel(gx, jgx) <= 1e-5
    assert _rel(gt, jgt) <= 1e-5
    cfg = th.HashGridConfig(**kw)
    grads = []
    for needs in (False, True):
        tab = _t(table).requires_grad_(True)
        out = th.hash_grid_encode(cfg, {"embeddings": tab},
                                  _t(x).requires_grad_(needs),
                                  _t(t).requires_grad_(needs))
        grads.append(torch.autograd.grad((out * _t(cot)).sum(), tab)[0])
    assert torch.equal(grads[0], grads[1])


@pytest.mark.parametrize("name", list(TEMPORAL))
def test_temporal_tv_loss_matches_jax(name):
    """temporal_tv_loss at the index_list row JAX draws from a key (handed
    to the port as an int and as a 0-d tensor), value and table gradient:
    1e-6 of the max (f32 means in another order)."""
    kw = TEMPORAL[name]
    jc, tc = jh.HashGridConfig(**kw), th.HashGridConfig(**kw)
    _x, _tm, table, _cot = _temporal_inputs(kw, 12)
    n_rows = jh.temporal_tables(jc)[3].shape[0]
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        row = int(jax.random.randint(key, (), 0, n_rows))
        want, jg = jax.value_and_grad(
            lambda tab: jh.temporal_tv_loss(jc, {"embeddings": tab}, key))(
            jnp.asarray(table))
        for r in (row, torch.tensor(row)):
            tt = _t(table).requires_grad_(True)
            got = th.temporal_tv_loss(tc, {"embeddings": tt}, r)
            got.backward()
            assert _rel(got, want) <= 1e-6
            assert _rel(tt.grad, jg) <= 1e-6


# ---------------------------------------------------------------------------
# scatter_add_rows' plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("c", [1, 2, 4, 8, 16, 32, 128])
def test_scatter_plain_matches_sorted_scatter_add(c):
    """G = K = 1 without weights on sorted indices against the Pallas
    kernel in interpret mode, every row width it accepts.  The TPU kernel
    rounds g to bf16, so it gets bf16-representable updates; then both add
    in f32: 1e-6 of the max."""
    rng = np.random.default_rng(10 + c)
    rows, m = 700, 3000
    idx = np.sort(rng.integers(0, rows, m)).astype(np.int32)
    g = np.asarray(jnp.asarray(rng.standard_normal((m, c)).astype(np.float32)
                               ).astype(jnp.bfloat16).astype(jnp.float32))
    want = jpk.sorted_scatter_add(jnp.asarray(g), jnp.asarray(idx), r=rows, c=c,
                                  interpret=True)
    got = sk.scatter_add_rows_plain(_t(g), _t(idx)[None, None], rows=rows)
    assert got.shape == (rows, c) and got.dtype == torch.float32
    assert _rel(got, want) <= 1e-6
    # the wrapper takes the plain version for CPU tensors, and counts nothing
    before = sk.scatter_add_rows.launches
    again = sk.scatter_add_rows(_t(g), _t(idx)[None, None], rows=rows)
    torch.testing.assert_close(again, got, rtol=0, atol=0)
    assert sk.scatter_add_rows.launches == before


@pytest.mark.parametrize("weights", [False, True])
def test_scatter_plain_matches_at_add_unsorted(weights):
    """Groups, corners and weights on unsorted indices against
    ``.at[].add`` of the expanded update stream: 1e-6 of the max."""
    rng = np.random.default_rng(20)
    rows, groups, corners, points, c = 97, 3, 8, 500, 2
    idx = rng.integers(0, rows, (groups, corners, points)).astype(np.int32)
    g = rng.standard_normal((points, groups * c)).astype(np.float32)
    ws = rng.uniform(0, 1, idx.shape).astype(np.float32) if weights else None
    upd = np.broadcast_to(
        g.reshape(points, groups, 1, c).transpose(1, 2, 0, 3),
        (groups, corners, points, c))
    if weights:
        upd = upd * ws[..., None]
    want = jnp.zeros((rows, c)).at[jnp.asarray(idx.reshape(-1))].add(
        jnp.asarray(upd.reshape(-1, c)))
    got = sk.scatter_add_rows(_t(g), _t(idx), None if ws is None else _t(ws),
                              rows=rows)
    assert _rel(got, want) <= 1e-6


def test_scatter_refuses_bad_operands_on_the_cpu_too():
    g = torch.zeros((5, 4))
    idx = torch.zeros((2, 3, 5), dtype=torch.int32)
    with pytest.raises(ValueError):
        sk.scatter_add_rows(g, idx.long(), rows=7)
    with pytest.raises(ValueError):
        sk.scatter_add_rows(torch.zeros((5, 6)), idx, rows=7)     # width 3
    with pytest.raises(ValueError):
        sk.scatter_add_rows(g, idx, torch.ones((2, 3, 4)), rows=7)
    for bad in (-1, 7):
        idx2 = idx.clone()
        idx2[1, 1, 1] = bad
        with pytest.raises(IndexError):
            sk.scatter_add_rows(g, idx2, rows=7)
    out = sk.scatter_add_rows(torch.zeros((0, 4)),
                              torch.zeros((2, 3, 0), dtype=torch.int32), rows=7)
    assert out.shape == (7, 2) and float(out.abs().max()) == 0.0


# ---------------------------------------------------------------------------
# scatter_add_rows' host-side plan: the shared-memory window and the count
# of atomic operations the CUDA kernel issues
# ---------------------------------------------------------------------------

def test_shared_window_holds_level_0_at_registered_widths():
    """The window the wrapper gives the kernel is level 0 of the nerfacto
    main, proposal_0 and proposal_1 grids (16^3 rows of 2 channels), in
    whole 16-byte pieces, and never more than the table."""
    for kw in (dict(num_levels=16, desired_resolution=2048, hash_scheme="zline"),
               dict(num_levels=5, desired_resolution=128, log2_hashmap_size=17),
               dict(num_levels=5, desired_resolution=256, log2_hashmap_size=17)):
        offsets = th.level_layout(th.HashGridConfig(**kw))[0]
        assert sk.shared_rows(offsets[-1], 2) == offsets[1] == 16**3
    for rows, c in ((2, 1), (3, 1), (5, 2), (1000, 1), (10**6, 128), (7, 8)):
        n = sk.shared_rows(rows, c)
        assert 0 <= n <= rows and (n * c) % 4 == 0 and n * c * 4 <= sk.SHARED_BYTES
    assert sk.shared_rows(7, 8) == 7 and sk.shared_rows(3, 1) == 0


def _emulate_scatter_kernel(g, idxs, ws, rows, *, strip, threads, sms):
    """snt_scatter_add_rows' walk, one item at a time: items (group,
    strip, corner, chunk), the blocks striding over them together, the run
    merge and the shared-memory window flushed per block.  Returns (table,
    counts as scatter_plan names them)."""
    groups, corners, points = idxs.shape
    c = g.shape[1] // groups
    window = sk.shared_rows(rows, c)
    vec = min(c, 4)
    chunks, strips = c // vec, -(-points // strip)
    items = groups * strips * corners * chunks
    blocks = max(1, min(sms, -(-items // threads)))
    idx, gg = idxs.numpy(), g.numpy().astype(np.float64)
    w = np.ones(idx.shape) if ws is None else ws.numpy().astype(np.float64)
    out = np.zeros((rows, c))
    n = dict(flushes=0, shared_adds=0, window_flushes=0, l2_reductions=0)
    for blk in range(blocks):
        shared = np.zeros((window, c))
        touched = set()

        def flush(row, acc, q):
            n["flushes"] += 1
            cols = slice(q * vec, q * vec + vec)
            if 0 <= row < window:
                shared[row, cols] += acc
                n["shared_adds"] += vec
                touched.add((row * c + q * vec) // 4)
            elif window <= row < rows:
                out[row, cols] += acc
                n["l2_reductions"] += 1

        for it in (i for i in range(items) if i // threads % blocks == blk):
            q, k = it % chunks, it // chunks % corners
            s, j = it // chunks // corners % strips, it // chunks // corners // strips
            cur = acc = None
            for b in range(s * strip, min(points, s * strip + strip)):
                term = gg[b, j * c + q * vec: j * c + q * vec + vec] * w[j, k, b]
                if idx[j, k, b] == cur:
                    acc = acc + term
                else:
                    if cur is not None:
                        flush(cur, acc, q)
                    cur, acc = int(idx[j, k, b]), term
            flush(cur, acc, q)
        out[:window] += shared
        n["window_flushes"] += len(touched)
        n["l2_reductions"] += len(touched)
    return out, n


def _ray_ordered_corners(kw, rays, samples, rng):
    """Corner rows and weights of points along rays, flattened ray by ray
    as the train path flattens its samples."""
    o = rng.uniform(0.2, 0.8, (rays, 1, 3))
    d = rng.standard_normal((rays, 1, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = np.sort(rng.uniform(0, 0.4, (rays, samples, 1)), axis=1)
    x = np.clip(o + t * d, 0, 1).reshape(-1, 3).astype(np.float32)
    return th.grid_corners(th.HashGridConfig(**kw), _t(x))


@pytest.mark.parametrize("case", ["zline", "xor", "tiled", "c1", "c4", "c8",
                                  "k1", "k4", "out_of_range"])
def test_scatter_plan_counts_the_kernels_walk(case, monkeypatch):
    """scatter_plan's vectorised counts against the kernel's walk emulated
    item by item, whose table equals the plain version's (1e-6 of the max),
    on ray-ordered hash-grid corners and on runs of one row, with a window
    that ends inside a level."""
    monkeypatch.setattr(sk, "SHARED_BYTES", 1024)
    rng = np.random.default_rng(len(case))
    ws = None
    if case in ("zline", "xor", "tiled"):
        kw = CONFIGS[case]
        idxs, ws = _ray_ordered_corners(kw, 12, 24, rng)
        rows = th.level_layout(th.HashGridConfig(**kw))[0][-1]
        c = 2
    else:
        c = {"c1": 1, "c4": 4, "c8": 8}.get(case, 2)
        corners = {"k1": 1, "k4": 4}.get(case, 8)
        rows = 300
        # runs of 1-9 equal rows
        lengths = rng.integers(1, 10, 60)
        first = rng.integers(0, rows - 1, (2, corners // 2 or 1, len(lengths)))
        r = np.repeat(first, lengths, axis=-1)
        idx = np.stack([r, r + 1], 2).reshape(2, -1, r.shape[-1])[:, :corners]
        if case == "out_of_range":
            idx[1, 3, 5] = rows
            idx[0, 0, 7] = -1
        idxs = _t(idx.astype(np.int32))
        ws = _t(rng.uniform(0, 1, idx.shape).astype(np.float32))
    groups, _k, points = idxs.shape
    g = _t(rng.standard_normal((points, groups * c)).astype(np.float32))
    strip = 8 if c <= 2 else 4
    table, counts = _emulate_scatter_kernel(g, idxs, ws, rows, strip=strip,
                                            threads=64, sms=3)
    plan = sk.scatter_plan(idxs, c, rows, strip=strip, threads=64, sms=3)
    assert plan == {"updates": idxs.numel(), **counts}
    assert plan["l2_reductions"] < plan["updates"]
    if case == "out_of_range":
        valid = (idxs >= 0) & (idxs < rows)
        idxs = torch.where(valid, idxs, torch.zeros_like(idxs))
        ws = ws * valid
    want = sk.scatter_add_rows_plain(g, idxs, ws, rows=rows)
    assert _rel(torch.from_numpy(table), want) <= 1e-6
