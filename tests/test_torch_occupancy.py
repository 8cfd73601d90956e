"""The port's occupancy grid (soccernerfs_tpu_torch/ops/occupancy.py)
against the JAX package on the CPU: the grid's init, the binarization,
the lookup, the static-shape volumetric sampler with and without JAX's
stratified jitter, the all-cells update and the sampled update after
warmup with JAX's draws (made from the same key splits as the JAX
function makes them), duplicate cells, and an all-empty grid.

Grids of 16^3 and 32^3 cells over the scene box [-1.5, 1.5]^3, 400 rays
from outside the box through it, 64 probes and 12 samples per ray.  The
density of the updates is an analytic function of the position (the
models' densities are tested in tests/test_torch_ngp_step.py).  Inputs
are made with numpy from a seed; every tolerance is stated with its
reason.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from soccernerfs_tpu.core.math import intersect_aabb as jax_intersect_aabb
from soccernerfs_tpu.core.rays import RayBundle as JaxRayBundle
from soccernerfs_tpu.ops import occupancy as jo
from soccernerfs_tpu_torch.core.rays import RayBundle
from soccernerfs_tpu_torch.ops import occupancy as to


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


AABB = np.array([[-1.5] * 3, [1.5] * 3], np.float32)
N_RAYS, PROBES, SAMPLES = 400, 64, 12
STEP_SIZE = 0.01


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _rays(seed=0):
    """Rays from a sphere of radius 4 towards points inside the box, with
    the JAX package's nears and fars (near plane 0.05): the same arrays on
    both sides."""
    rng = np.random.default_rng(seed)
    org = rng.standard_normal((N_RAYS, 3)).astype(np.float32)
    org = (org / np.linalg.norm(org, axis=1, keepdims=True) * 4).astype(np.float32)
    d = rng.uniform(-1, 1, (N_RAYS, 3)).astype(np.float32) - org
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    nears, fars = (np.asarray(x) for x in jax_intersect_aabb(
        jnp.asarray(org), jnp.asarray(d), jnp.asarray(AABB), near_plane=0.05))
    return dict(origins=org, directions=d, pixel_area=np.ones(N_RAYS, np.float32),
                nears=nears, fars=fars)


def _configs(r):
    return jo.OccupancyGridConfig(resolution=r), to.OccupancyGridConfig(resolution=r)


def _occs(r, seed, p=0.4):
    """A grid whose cells are empty (0) or dense (U(0.5, 1)): no cell sits
    near the threshold, where the two means' roundings could differ."""
    rng = np.random.default_rng(seed)
    n = r**3
    return np.where(rng.uniform(size=n) < p, rng.uniform(0.5, 1.0, n),
                    0.0).astype(np.float32)


def _density_jax(p):
    return jnp.exp(-jnp.sum(p * p, axis=-1)) * 3.0


def _density_torch(p):
    return torch.exp(-torch.sum(p * p, dim=-1)) * 3.0


def _jax_draws(key, r, step):
    """The draws update_occupancy_grid makes from ``key``: its split into
    (jitter, uniform cells, occupied-cell uniforms) keys, then each
    draw at its shape."""
    k_jit, k_uni, k_occ = jax.random.split(key, 3)
    n = r**3
    if step is None or step < jo.OccupancyGridConfig().warmup_steps:
        return {"jitter": _t(jax.random.uniform(k_jit, (n, 3)))}
    m = n // 4
    return {"jitter": _t(jax.random.uniform(k_jit, (m, 3))),
            "cells": _t(jax.random.randint(k_uni, (m // 2,), 0, n)).long(),
            "occupied": _t(jax.random.uniform(k_occ, (m - m // 2,)))}


def _sampled_cells(draws, occs, r):
    """The cells a sampled update probes, as the port picks them."""
    w = to.occupancy_binary(to.OccupancyGridConfig(resolution=r),
                            _t(occs)).float() + 1e-12
    cdf = torch.cumsum(w, 0)
    picks = torch.searchsorted(cdf, draws["occupied"] * cdf[-1])
    return torch.cat([draws["cells"], picks.clamp(0, r**3 - 1)])


# ---------------------------------------------------------------------------
# the grid, the binary, the lookup
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scale", [1.0, 1e-4])
def test_init_and_binary_match_jax(scale):
    """init: zeros of [R^3] f32.  The binary: occ > min(mean, 0.01), the
    mean above the threshold (scale 1) and below it (scale 1e-4): equal to
    JAX's on every cell farther than 1e-6 (relative) from the threshold
    (the port sums the mean in f64, JAX in f32; the two may round a cell
    at the threshold either way)."""
    jcfg, tcfg = _configs(32)
    occ0 = to.init_occupancy_grid(tcfg)
    assert occ0.shape == (32**3,) and occ0.dtype == torch.float32
    assert not occ0.any()
    np.testing.assert_array_equal(np.asarray(jo.init_occupancy_grid(jcfg)), occ0.numpy())
    occs = (np.random.default_rng(1).exponential(1.0, 32**3) * scale).astype(np.float32)
    want = np.asarray(jo.occupancy_binary(jcfg, jnp.asarray(occs)))
    got = to.occupancy_binary(tcfg, _t(occs)).numpy()
    thresh = min(float(occs.astype(np.float64).mean()), 0.01)
    far = np.abs(occs - thresh) > 1e-6 * thresh
    assert far.mean() > 0.99
    np.testing.assert_array_equal(got[far], want[far])
    assert (thresh == 0.01) == (scale == 1.0)
    assert 0.3 < got.mean() < 1.0


def test_lookup_matches_jax():
    """occupancy_lookup at positions inside and outside the box, on the
    faces and the cell boundaries: exactly JAX's."""
    jcfg, tcfg = _configs(16)
    rng = np.random.default_rng(2)
    binary = rng.uniform(size=16**3) < 0.5
    pos = rng.uniform(-1.8, 1.8, (3000, 3)).astype(np.float32)
    pos[:300] = np.round(pos[:300] / 0.1875) * 0.1875   # cell boundaries
    pos[300:310, 0] = 1.5
    pos[310:320, 1] = -1.5
    want = np.asarray(jo.occupancy_lookup(jcfg, jnp.asarray(binary),
                                          jnp.asarray(AABB), jnp.asarray(pos)))
    got = to.occupancy_lookup(tcfg, _t(binary), _t(AABB), _t(pos)).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0.1 < got.mean() < 0.5


# ---------------------------------------------------------------------------
# the sampler
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grid", ["random", "full", "empty"])
@pytest.mark.parametrize("stratified", [False, True])
@pytest.mark.parametrize("r", [16, 32])
def test_volumetric_sample_matches_jax(r, stratified, grid):
    """volumetric_sample on the same rays, binary and (stratified) JAX's
    own jitter, uniform(key, [N, 1]): the selection (the probe of each
    sample, read from spacing_starts / spacing_ends, the probe's edges)
    and the valid mask equal JAX's exactly, and so do s_near / s_far.
    starts and ends are within one f32 ulp: XLA's CPU fuses ``near +
    edge * (far - near)`` into one FMA, which rounds once; the port's
    equal that expression rounded after the product and after the sum
    (numpy), exactly."""
    jcfg, tcfg = _configs(r)
    rays = _rays(r)
    rng = np.random.default_rng(r + 1)
    binary = {"random": rng.uniform(size=r**3) < 0.3,
              "full": np.ones(r**3, bool),
              "empty": np.zeros(r**3, bool)}[grid]
    key = jax.random.PRNGKey(5)
    jrays = JaxRayBundle(**{k: jnp.asarray(v) for k, v in rays.items()})
    js, jvalid = jax.jit(lambda b, rb: jo.volumetric_sample(
        jcfg, b, rb, jnp.asarray(AABB), PROBES, SAMPLES, rng=key,
        stratified=stratified))(jnp.asarray(binary), jrays)
    jitter = _t(jax.random.uniform(key, (N_RAYS, 1))) if stratified else None
    ts, tvalid = to.volumetric_sample(
        tcfg, _t(binary), RayBundle(**{k: _t(v) for k, v in rays.items()}),
        _t(AABB), PROBES, SAMPLES, jitter=jitter)

    assert ts.spacing == js.spacing == "uniform"
    assert tvalid.shape == (N_RAYS, SAMPLES) and tvalid.dtype == torch.bool
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
    for k in ("spacing_starts", "spacing_ends", "s_near", "s_far"):
        np.testing.assert_array_equal(getattr(ts, k).numpy(),
                                      np.asarray(getattr(js, k)), err_msg=k)
    edges = np.arange(PROBES + 1, dtype=np.float32) / np.float32(PROBES)
    if stratified:
        edges = edges + jitter.numpy() / np.float32(PROBES)
    t_edges = rays["nears"][:, None] + edges * (rays["fars"] - rays["nears"])[:, None]
    for k, lo in (("starts", 0), ("ends", 1)):
        want = np.asarray(getattr(js, k))
        got = getattr(ts, k).numpy()
        assert np.all(np.abs(got - want) <= np.spacing(np.abs(want))), k
        # the port's: the unfused expression at the selected probe
        idx = np.stack([np.searchsorted(e, s, side="left") for e, s in zip(
            np.broadcast_to(edges, (N_RAYS, PROBES + 1)),
            ts.spacing_starts.numpy())]) + lo
        np.testing.assert_array_equal(got, np.take_along_axis(t_edges, idx, 1))
    counts = tvalid.sum(1).numpy()
    if grid == "empty":
        assert counts.max() == 0
    elif grid == "full":
        assert counts.min() == SAMPLES
    else:
        assert 0 < counts.mean() < SAMPLES and counts.min() < SAMPLES


def test_volumetric_sample_needs_nears_and_fars():
    """Rays without nears or fars are refused."""
    rays = {k: _t(v) for k, v in _rays().items()}
    rays["nears"] = None
    with pytest.raises(ValueError, match="nears and fars"):
        to.volumetric_sample(to.OccupancyGridConfig(resolution=16),
                             torch.ones(16**3, dtype=torch.bool),
                             RayBundle(**rays), _t(AABB), PROBES, SAMPLES)


# ---------------------------------------------------------------------------
# the updates
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("step", [None, 0, 255])
def test_full_update_matches_jax(step):
    """The update while ``step < warmup_steps`` (or without a step): every
    cell probed at its jittered position with JAX's jitter draw, the EMA
    kept as max(occ * 0.95, density * step size).  1e-6 relative of the
    grid's max (torch's and XLA's exp differ in the last bits); the same
    cells change."""
    jcfg, tcfg = _configs(16)
    occs = _occs(16, 3)
    key = jax.random.PRNGKey(7)
    want = np.asarray(jo.update_occupancy_grid(
        jcfg, jnp.asarray(occs), jnp.asarray(AABB), _density_jax, key,
        STEP_SIZE, step=step))
    draws = _jax_draws(key, 16, step)
    assert draws["jitter"].shape == (16**3, 3)
    got = to.update_occupancy_grid(tcfg, _t(occs), _t(AABB), _density_torch,
                                   STEP_SIZE, step=step, draws=draws).numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    np.testing.assert_array_equal(got != occs, want != occs)
    assert (got != occs).all()    # every cell decays or takes its density


@pytest.mark.parametrize("r", [16, 32])
def test_sampled_update_matches_jax(r):
    """After warmup: n_cells // 4 probes, half JAX's uniform cells, half
    drawn from the binary grid's CDF with JAX's uniforms; unprobed cells
    keep their value, probed ones max(occ * 0.95, per-cell max density).
    The grid is empty or dense cell by cell, so both sides binarize it
    alike and pick the same cells: the cells that change are JAX's, the
    values within 1e-6 relative of the max (exp's last bits)."""
    jcfg, tcfg = _configs(r)
    occs = _occs(r, r)
    key = jax.random.PRNGKey(11)
    step = 10_000
    want = np.asarray(jo.update_occupancy_grid(
        jcfg, jnp.asarray(occs), jnp.asarray(AABB), _density_jax, key,
        STEP_SIZE, step=step))
    draws = _jax_draws(key, r, step)
    m = r**3 // 4
    assert draws["jitter"].shape == (m, 3)
    assert draws["cells"].shape == (m // 2,) and draws["occupied"].shape == (m - m // 2,)
    got = to.update_occupancy_grid(tcfg, _t(occs), _t(AABB), _density_torch,
                                   STEP_SIZE, step=step, draws=draws).numpy()
    changed = got != occs
    np.testing.assert_array_equal(changed, want != occs)
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    # the occupied draw lands on occupied cells only
    cells = _sampled_cells(draws, occs, r)
    assert (occs[cells[m // 2:].numpy()] > 0).all()
    assert changed.sum() == len(np.unique(cells.numpy()))


def test_duplicate_cells_take_their_max():
    """A cell drawn more than once (the CDF draw is with replacement) takes
    the max of its probes' densities, as the JAX package's scatter-max: a
    grid with 8 occupied cells of 4096, each at 1e-6 (below every probe's
    density), draws each of them ~64 times at jitters of the cell that
    differ; checked against the per-cell max computed by hand, and against
    JAX's (1e-6 relative, exp's last bits)."""
    jcfg, tcfg = _configs(16)
    occs = np.zeros(16**3, np.float32)
    occupied = np.random.default_rng(4).choice(16**3, 8, replace=False)
    occs[occupied] = 1e-6
    key = jax.random.PRNGKey(13)
    want = np.asarray(jo.update_occupancy_grid(
        jcfg, jnp.asarray(occs), jnp.asarray(AABB), _density_jax, key,
        STEP_SIZE, step=300))
    draws = _jax_draws(key, 16, 300)
    got = to.update_occupancy_grid(tcfg, _t(occs), _t(AABB), _density_torch,
                                   STEP_SIZE, step=300, draws=draws)
    assert np.abs(got.numpy() - want).max() <= 1e-6 * np.abs(want).max()
    cells = _sampled_cells(draws, occs, 16)
    picks = cells[512:]
    assert set(picks.tolist()) == set(occupied.tolist())
    r = 16
    ijk = torch.stack([cells // (r * r), (cells // r) % r, cells % r], -1)
    pos = _t(AABB)[0] + (ijk.float() + draws["jitter"]) / r * 3.0
    dens = _density_torch(pos) * STEP_SIZE
    for cell in occupied:
        mine = dens[cells == int(cell)]
        assert mine.numel() > 16 and float(mine.max()) > float(mine.min())
        assert float(mine.min()) > 1e-6
        assert float(got[cell]) == float(mine.max())


def test_all_empty_grid_is_sampled_uniformly():
    """An all-empty grid (nothing above the threshold) after warmup: its CDF
    holds only the 1e-12 terms, whose f32 partial sums XLA and torch round
    differently, so the occupied draw is compared by counts, not cells:
    the cells probed number as many as JAX's within 1 % (of 8,192 probes,
    ~6,900 distinct cells), the probed cells fall in the grid's 8 octants
    as JAX's within 2 % of the probes, and the grid takes density on
    exactly the probed cells."""
    jcfg, tcfg = _configs(32)
    occs = np.zeros(32**3, np.float32)
    key = jax.random.PRNGKey(17)
    want = np.asarray(jo.update_occupancy_grid(
        jcfg, jnp.asarray(occs), jnp.asarray(AABB), _density_jax, key,
        STEP_SIZE, step=400))
    draws = _jax_draws(key, 32, 400)
    got = to.update_occupancy_grid(tcfg, _t(occs), _t(AABB), _density_torch,
                                   STEP_SIZE, step=400, draws=draws).numpy()
    assert not to.occupancy_binary(tcfg, _t(occs)).any()
    n_got, n_want = (got > 0).sum(), (want > 0).sum()
    assert abs(n_got - n_want) <= 0.01 * n_want and n_want > 6000
    cells = _sampled_cells(draws, occs, 32).numpy()
    assert (got > 0).sum() == len(np.unique(cells))

    def octants(grid):
        idx = np.flatnonzero(grid > 0)
        i, j, k = idx // 1024, (idx // 32) % 32, idx % 32
        return np.bincount((i >= 16) * 4 + (j >= 16) * 2 + (k >= 16), minlength=8)

    assert np.abs(octants(got) - octants(want)).max() <= 0.02 * 8192


def test_update_draws_layout():
    """update_draws: the all-cells jitter before warmup (and without a
    step), the three draws at their shapes after it, from the generator."""
    cfg = to.OccupancyGridConfig(resolution=16)
    gen = torch.Generator().manual_seed(0)
    for step in (None, 0, 255):
        d = to.update_draws(cfg, step, gen, "cpu")
        assert set(d) == {"jitter"} and d["jitter"].shape == (4096, 3)
    d = to.update_draws(cfg, 256, gen, "cpu")
    assert d["jitter"].shape == (1024, 3)
    assert d["cells"].shape == (512,) and d["cells"].dtype == torch.int64
    assert 0 <= int(d["cells"].min()) and int(d["cells"].max()) < 4096
    assert d["occupied"].shape == (512,)
    bad = dict(d, jitter=d["jitter"][:5])
    with pytest.raises(ValueError, match="jitter"):
        to.update_occupancy_grid(cfg, torch.zeros(4096), _t(AABB), _density_torch,
                                 STEP_SIZE, step=256, draws=bad)
