"""The port's data parallelism (soccernerfs_tpu_torch/parallel/mesh.py and
the sharded step and render) against the JAX package's, on the CPU.

Ranks are processes joined over gloo through a ``file://`` store (under
the test's temporary directory), started by ``parallel.mesh.spawn`` with a
join timeout: rank 0 runs in this process, rank 1 in a spawned one, which
runs ``tests/torch_parallel_ranks.py`` (no JAX there).  One spawned pair
runs every job of the module (the three families' steps, the render, the
averages), whose results the tests below read.

- ``shard_rows`` against the addressable shards of JAX's ``shard_batch``
  for 2, 4 and 8 devices of the conftest's 8-device mesh.
- A 2-rank step of each of ``tests/test_multichip.py``'s
  ``SHARD_FAMILIES`` (k-planes-static, instant-ngp, nerfplayer-nerfacto,
  at those widths) against the mean over the two shards of the JAX
  Trainer's ``_shard_loss_and_grads``, each shard's draws made from its
  shard key (``fold_in(fold_in(key, step), shard)``, split into the
  forward's and the loss's keys) as the step tests make them; the same
  params and batch on both sides.  Tolerances, as
  tests/test_torch_train_step.py holds one step: loss terms 1e-4 relative
  (f32 sums in another order; bf16 MLP operands that round the other way),
  but the plane regularizers', whose bf16 differences XLA leaves unrounded
  under jit (``BF16_DIFFERENCE_TOL``); every gradient leaf within 2e-2 of
  its max (a flipped bf16 rounding of an MLP operand is a 2^-8 step).
- After the update (and instant-ngp's all-cells grid update), and after a
  whole ``train_iteration`` from the port's own generators, every tensor
  of the state bit-equal across the ranks.
- ``force_shard_map`` at world size 1 for the same families: two steps,
  finite losses; k-planes-static's first step (loss terms, metrics, the
  updated params) bit-equal to the unsharded step's given the same rows
  and a generator of (seed, step, 0).
- The 2-rank render of a 16x24 image (chunk 128, and 91, rounded up to 92,
  with a padded tail) within 1e-5 of the unsharded render.
- ``all_mean`` over buckets of mixed dtypes, a tensor past the bucket
  size, an integer and a None; a rank that raises fails ``spawn`` within
  its timeout, with its traceback.
"""
import copy
import dataclasses
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from soccernerfs_tpu.configs.method_configs import method_configs
from soccernerfs_tpu.data.dataparsers.blender import BlenderDataParserConfig
from soccernerfs_tpu.data.dataparsers.soccer import (
    BroadcaststyleDataParserConfig,
)
from soccernerfs_tpu.data.fixtures import (
    make_blender_fixture,
    make_broadcaststyle_fixture,
)
from soccernerfs_tpu.engine.trainer import Trainer as JaxTrainer
from soccernerfs_tpu.parallel import mesh as jmesh
from soccernerfs_tpu_torch.configs import method_configs as tmc
from soccernerfs_tpu_torch.data.dataparsers import blender as tblender
from soccernerfs_tpu_torch.data.dataparsers import soccer as tsoccer
from soccernerfs_tpu_torch.data import fixtures as tfixtures
from soccernerfs_tpu_torch.engine.trainer import (
    CAMERA_OPT_GROUP,
    Trainer,
    TrainStep,
    step_seed,
)
from soccernerfs_tpu_torch.models import kplanes as tkp
from soccernerfs_tpu_torch.models import nerfplayer_nerfacto as tnpn
from soccernerfs_tpu_torch.ops.hash_grid import temporal_tables
from soccernerfs_tpu_torch.parallel import mesh
from soccernerfs_tpu_torch.utils.tree import tree_leaves
from test_multichip import SHARD_FAMILIES
import torch_parallel_ranks as ranks

METHODS = sorted(SHARD_FAMILIES)
RAYS = 64
# The plane regularizers take their differences in bf16 (both packages'
# ops/losses.py).  The port rounds each difference to bf16, as the JAX
# function does run eagerly; under jit XLA fuses the subtraction into the
# f32 square and does not round it (ROADMAP C.40).  A rounded difference is
# within one bf16 unit roundoff u = 2^-8 of the exact one, so each squared
# term, and their mean, within 2u + u^2 relative.
BF16_DIFFERENCE_TERMS = {"space_tv_loss", "space_tv_proposal_loss",
                         "time_smoothness_loss", "time_smoothness_proposal_loss"}
BF16_DIFFERENCE_TOL = 2 * 2.0**-8 + 2.0**-16
# the pair's collectives and joins: far above what they take here
TIMEOUT_S = 180.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch CPU thread while this file runs (the suite runs in
    parallel worker processes, whose default thread pools oversubscribe
    the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _paths(tree, prefix=()):
    """Leaf paths of a nested dict / list tree, in the port's
    ``tree_leaves`` order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, prefix + (i,))
    else:
        yield prefix


def _jax_leaves(tree) -> dict:
    """{path: leaf} of a JAX pytree, paths as ``_paths`` writes them."""
    return {tuple(p.key if hasattr(p, "key") else p.idx for p in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


# ---------------------------------------------------------------------------
# shard_rows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 4, 8])
def test_shard_rows_matches_shard_batch(n):
    devices = jax.devices()[:n]
    batch = {"x": np.arange(64 * 3, dtype=np.float32).reshape(64, 3),
             "i": np.arange(64, dtype=np.int32) * 7}
    sharded = jmesh.shard_batch(batch, jmesh.make_data_mesh(devices))
    for k, v in batch.items():
        shards = {devices.index(s.device): np.asarray(s.data)
                  for s in sharded[k].addressable_shards}
        assert sorted(shards) == list(range(n))
        for r in range(n):
            mine = mesh.shard_rows(batch, r, n)[k]
            np.testing.assert_array_equal(mine, shards[r])
            np.testing.assert_array_equal(
                mesh.shard_rows({k: torch.from_numpy(v)}, r, n)[k].numpy(),
                shards[r])
    with pytest.raises(ValueError, match="does not split over"):
        mesh.shard_rows({"x": np.zeros((63, 3))}, 0, n)


def test_buckets_and_world_sizes(monkeypatch):
    monkeypatch.setattr(mesh, "BUCKET_BYTES", 64)
    ts = [torch.zeros(4), torch.zeros(20), torch.zeros(4, dtype=torch.bfloat16),
          torch.zeros(8), torch.zeros(2), torch.zeros(16, dtype=torch.bfloat16),
          torch.zeros(4)]
    # f32 packed up to 64 bytes: 16 + 32 + 8 B, then 16 B opens another;
    # the 80-byte tensor alone; bf16 8 + 32 B
    assert mesh._buckets(ts) == [[0, 3, 4], [1], [2, 5], [6]]
    assert mesh.local_world_size(-1, "cpu") == 1
    assert mesh.local_world_size(3, "cpu") == 3
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert mesh.local_world_size(-1, "cuda") == 2
    assert mesh.local_world_size(1, "cuda") == 1
    assert mesh.local_world_size(8, "cuda") == 2
    assert mesh.current_world() is None and mesh.world_size() == 1
    assert mesh.is_main_process()


# ---------------------------------------------------------------------------
# the three families' sharded steps against JAX's shard mean
# ---------------------------------------------------------------------------

def _jax_trainer(root, method):
    cfg = copy.deepcopy(method_configs[method])
    cfg.vis = "terminal"
    cfg.output_dir = root / "out"
    cfg.steps_per_save = 10**9
    cfg.steps_per_eval_batch = 0
    cfg.steps_per_eval_image = 0
    cfg.steps_per_eval_all_images = 0
    cfg.machine.num_devices = 2
    cfg.pipeline.model = dataclasses.replace(cfg.pipeline.model,
                                             **SHARD_FAMILIES[method])
    dm = cfg.pipeline.datamanager
    if method == "nerfplayer-nerfacto":
        data = make_broadcaststyle_fixture(root / "data", num_cameras=3,
                                           num_steps=3, h=12, w=16)
        dm.dataparser = BroadcaststyleDataParserConfig(data=data,
                                                       fps_downsample=1.0)
        dm.pick_mode = "normal"
        dm.iters_to_start_is = 1
    else:
        make_blender_fixture(str(root / "data"), num_frames=2, h=24, w=24)
        dm.dataparser = BlenderDataParserConfig(data=root / "data")
    dm.train_num_rays_per_batch = RAYS
    cfg.set_timestamp()
    return JaxTrainer(cfg).setup()


def _jax_draws(method, tcfg, key, key_loss, n):
    """The JAX shard's draws from its keys, as the step tests make them:
    get_outputs splits its key into (sampling, background); the proposal
    models split the sampling key into one per level (a jitter [N, S + 1],
    or [N, 1] with a single jitter), the occupancy model draws one [N, 1];
    the temporal TV draws one row per grid from the loss key."""
    rng_s, rng_bg = jax.random.split(key)
    if method == "instant-ngp":
        jitters = [jax.random.uniform(rng_s, (n, 1))]
    else:
        counts = (tkp if method == "k-planes-static" else tnpn).sample_counts(tcfg)
        keys = jax.random.split(rng_s, len(counts))
        jitters = [jax.random.uniform(k, (n, 1 if tcfg.use_single_jitter
                                          else s + 1))
                   for k, s in zip(keys, counts)]
    random_bg = getattr(tcfg, "background_color", "random") == "random"
    draws = {"jitters": [np.asarray(j) for j in jitters],
             "background": (np.asarray(jax.random.uniform(rng_bg, (n, 3)))
                            if random_bg else None)}
    if method == "nerfplayer-nerfacto":
        grids = tnpn.tv_grids(tcfg)
        draws["tv_rows"] = [
            int(jax.random.randint(k, (), 0, temporal_tables(g)[3].shape[0]))
            for k, g in zip(jax.random.split(key_loss, len(grids)), grids)]
    return draws


def _family(root, method):
    """(JAX's shard mean of loss, loss dict, metrics and grads; the job the
    port's ranks run) at step 0 of the family's JAX Trainer."""
    jt = _jax_trainer(root, method)
    aux = jt.state.aux
    if method == "instant-ngp":
        # a grid empty or dense cell by cell (a fresh grid is empty: the
        # step would see no sample)
        rng = np.random.default_rng(5)
        occs = np.where(rng.uniform(size=aux["occs"].shape) < 0.5, 1.0,
                        0.0).astype(np.float32)
        aux = {**aux, "occs": jnp.asarray(occs)}
    raw = jt.datamanager.next_train_raw(0)
    batch = {"cam_idx": raw["indices"][:, 0].astype(np.int32),
             "coords": raw["indices"][:, 1:].astype(np.float32) + 0.5,
             "image": raw["image"].astype(np.float32)}
    host = (jt.model.host_static_kwargs(jt.model_cfg, 0, {})
            if hasattr(jt.model, "host_static_kwargs") else {})
    step0 = jnp.asarray(0, jnp.int32)
    sched = (jt.model.schedules(jt.model_cfg, step0, aux)[0]
             if hasattr(jt.model, "schedules") else {})
    sched.update(host)
    params = jax.device_get(jt.state.params)
    shard_fn = jax.jit(lambda p, b, s: jt._shard_loss_and_grads(
        p, b, step0, sched, shard_idx=s))

    tcfg = dataclasses.replace(tmc.model_configs[method], **SHARD_FAMILIES[method])
    tcfg_train = tmc.trainer_configs[method]
    cam_opt = tcfg_train.pipeline.datamanager.camera_optimizer
    optimizers = dict(tcfg_train.optimizers)
    if cam_opt.mode != "off":
        optimizers.setdefault("camera_opt", CAMERA_OPT_GROUP)
    per_shard, shards = [], []
    for s in range(2):
        rows = {k: v[s * RAYS // 2:(s + 1) * RAYS // 2] for k, v in batch.items()}
        (loss, (ld, met)), grads = shard_fn(
            params, {k: jnp.asarray(v) for k, v in rows.items()},
            jnp.asarray(s, jnp.int32))
        per_shard.append((loss, ld, met, _jax_leaves(grads)))
        key = jax.random.fold_in(jax.random.fold_in(jt.train_rng, step0), s)
        rng, rng_loss = jax.random.split(key)
        shards.append({"batch": rows,
                       "draws": _jax_draws(method, tcfg, rng, rng_loss, RAYS // 2)})

    def mean(values):
        return np.mean([np.asarray(v, np.float64) for v in values], axis=0)

    want = {"loss": mean([p[0] for p in per_shard]),
            "loss_dict": {k: mean([p[1][k] for p in per_shard])
                          for k in per_shard[0][1]},
            "metrics": {k: mean([p[2][k] for p in per_shard])
                        for k in per_shard[0][2]},
            "grads": {path: mean([p[3][path] for p in per_shard])
                      for path in per_shard[0][3]}}
    cams = jt.train_cameras
    job = {"kind": "step", "cfg": tcfg, "model": tmc.model_names[method],
           "optimizers": optimizers, "camera_optimizer": cam_opt,
           "cameras": {f.name: np.asarray(getattr(cams, f.name))
                       for f in dataclasses.fields(cams)
                       if getattr(cams, f.name) is not None},
           "aabb": np.array(jt.aabb),
           "params": jax.tree_util.tree_map(np.asarray, params),
           "aux": ({k: np.asarray(v) for k, v in aux.items()}
                   if method == "instant-ngp" else None),
           "step": 0, "flag": host.get("train_proposal_networks", True),
           "shards": shards}
    want["paths"] = list(_paths(job["params"]))
    return want, job


RENDER_CFG = dataclasses.replace(tmc.model_configs["k-planes-static"],
                                 **SHARD_FAMILIES["k-planes-static"])
RENDER_CHUNKS = (128, 91)
ALL_MEAN = {"kind": "all_mean", "shapes": [(3,), (5, 2), (), ((32 << 20) // 4 + 3,),
                                           (4, 4)], "none_at": 4}


def _render_job():
    c2w = np.eye(3, 4, dtype=np.float32)[None].copy()
    c2w[0, :, 3] = [0.1, -0.2, 2.8]
    return {"kind": "render", "cfg": RENDER_CFG, "chunks": RENDER_CHUNKS,
            "aabb": np.array([[-1.5] * 3, [1.5] * 3], np.float32),
            "cameras": {"camera_to_worlds": c2w,
                        **{k: np.array([v], np.float32) for k, v in
                           (("fx", 20.0), ("fy", 21.0), ("cx", 12.0),
                            ("cy", 8.0))},
                        "width": np.array([24], np.int32),
                        "height": np.array([16], np.int32),
                        "camera_type": np.array([1], np.int32)}}


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """Every job of this module on one spawned pair of ranks: {method:
    (JAX's shard mean, both ranks' step results)}, the render's and the
    averages' results of both ranks."""
    root = tmp_path_factory.mktemp("parallel")
    wants, jobs = {}, []
    for method in METHODS:
        wants[method], job = _family(root / method, method)
        jobs.append(job)
    jobs += [_render_job(), ALL_MEAN]
    t0 = time.perf_counter()
    results = mesh.spawn(ranks.run_jobs, 2, (jobs,), devices=["cpu", "cpu"],
                         init_method=f"file://{root / 'store'}",
                         timeout_s=TIMEOUT_S)
    assert time.perf_counter() - t0 < TIMEOUT_S
    by_rank = [dict(zip([*METHODS, "render", "all_mean"], r)) for r in results]
    return wants, by_rank


@pytest.mark.parametrize("method", METHODS)
def test_two_rank_step_matches_jax_shard_mean(pair, method):
    wants, by_rank = pair
    want = wants[method]
    got = by_rank[0][method]
    assert _rel(got["loss"], want["loss"]) <= 1e-4
    assert set(got["loss_dict"]) == set(want["loss_dict"])
    for k in want["loss_dict"]:
        tol = BF16_DIFFERENCE_TOL if k in BF16_DIFFERENCE_TERMS else 1e-4
        assert _rel(got["loss_dict"][k], want["loss_dict"][k]) <= tol, k
    assert set(got["metrics"]) == set(want["metrics"])
    for k in want["metrics"]:
        assert _rel(got["metrics"][k], want["metrics"][k]) <= 1e-4, k
    paths = want["paths"]
    assert sorted(paths, key=str) == sorted(want["grads"], key=str)
    assert len(got["grads"]) == len(paths)
    for path, g in zip(paths, got["grads"]):
        jg = want["grads"][path]
        assert g.shape == jg.shape, path
        if np.abs(jg).max() == 0.0:
            assert np.abs(g).max() == 0.0, path
            continue
        assert _rel(g, jg) <= 2e-2, (path, _rel(g, jg))
    # both ranks hold the same averages
    other = by_rank[1][method]
    assert other["loss"] == got["loss"]
    for a, b in zip(other["grads"], got["grads"]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("method", METHODS)
def test_state_stays_replicated(pair, method):
    """Every tensor of the state (params, moments, an occupancy grid) equal
    across the ranks after the update and the model's state update, and
    after a whole ``train_iteration``; instant-ngp's grid moved."""
    _, by_rank = pair
    for key in ("digests", "iteration_digests"):
        d0, d1 = by_rank[0][method][key], by_rank[1][method][key]
        assert d0.shape[0] == 2
        np.testing.assert_array_equal(d0, d1)
        np.testing.assert_array_equal(d0[0], d0[1])
    if method == "instant-ngp":
        occs = [r[method]["aux"]["occs"] for r in by_rank]
        np.testing.assert_array_equal(occs[0], occs[1])
        assert np.unique(occs[0]).size > 2


@pytest.mark.parametrize("chunk", RENDER_CHUNKS)
def test_sharded_render_matches_unsharded(pair, chunk):
    _, by_rank = pair
    for r in (0, 1):
        sharded = by_rank[r]["render"][("sharded", chunk)]
        direct = by_rank[0]["render"][("direct", chunk)]
        assert sharded["rgb"].shape == (16, 24, 3)
        assert set(sharded) == set(direct)
        for k in direct:
            np.testing.assert_allclose(sharded[k], direct[k], rtol=0, atol=1e-5)
    assert np.abs(direct["rgb"] - direct["rgb"].mean()).max() > 1e-3


def test_all_mean_buckets_dtypes_and_nones(pair):
    _, by_rank = pair
    mine = [r["all_mean"][0] for r in by_rank]
    means = [r["all_mean"][1] for r in by_rank]
    dtypes = by_rank[0]["all_mean"][2]
    none_at = ALL_MEAN["none_at"]
    for i in range(len(mine[0])):
        a = mine[0][i]
        b = np.zeros_like(a) if i == none_at else mine[1][i]
        want = (a + b) / 2
        if dtypes[i] == "torch.bfloat16":
            want = torch.from_numpy(want).to(torch.bfloat16).float().numpy()
        np.testing.assert_array_equal(means[0][i], want)
        np.testing.assert_array_equal(means[1][i], means[0][i])
    assert dtypes == ["torch.float32"] * 6 + ["torch.bfloat16"]
    assert means[0][-2] == 3.5   # the int64 3 and 4, averaged as f32


def test_a_failing_rank_fails_spawn_within_its_timeout(tmp_path):
    t0 = time.perf_counter()
    with pytest.raises(Exception) as info:
        mesh.spawn(ranks.fail_on_rank, 2, (1,), devices=["cpu", "cpu"],
                   init_method=f"file://{tmp_path / 'store'}", timeout_s=60)
    assert time.perf_counter() - t0 < 60
    text = str(info.value) + "".join(getattr(info.value, "__notes__", []))
    assert "rank 1 fails on purpose" in text
    assert not mesh.current_world()


# ---------------------------------------------------------------------------
# force_shard_map at world size 1
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_data")
    blender = tfixtures.make_blender_fixture(root / "blender", num_frames=2,
                                             h=24, w=24)
    broadcast = tfixtures.make_broadcaststyle_fixture(
        root / "broadcast", num_cameras=3, num_steps=3, h=12, w=16)
    return root, blender, broadcast


def _port_config(port_data, method):
    root, blender, broadcast = port_data
    cfg = copy.deepcopy(tmc.trainer_configs[method])
    cfg.vis = "terminal"
    cfg.output_dir = root / "out" / method
    cfg.max_num_iterations = 2
    cfg.steps_per_save = 0
    cfg.steps_per_eval_batch = 0
    cfg.steps_per_eval_image = 0
    cfg.steps_per_eval_all_images = 0
    cfg.machine.force_shard_map = True
    cfg.pipeline.model = dataclasses.replace(cfg.pipeline.model,
                                             **SHARD_FAMILIES[method])
    dm = cfg.pipeline.datamanager
    if method == "nerfplayer-nerfacto":
        dm.dataparser = tsoccer.BroadcaststyleDataParserConfig(
            data=broadcast, fps_downsample=1.0)
        dm.pick_mode = "normal"
        dm.iters_to_start_is = 1
    else:
        dm.dataparser = tblender.BlenderDataParserConfig(data=blender)
    dm.train_num_rays_per_batch = RAYS
    cfg.set_timestamp()
    return cfg


def _world_one(device, config, compare):
    """Two steps of a Trainer with ``force_shard_map`` on this rank of a
    world of one; with ``compare``, its first step against the unsharded
    TrainStep's on a copy of the state, with the same rows and a generator
    of (seed, step, 0)."""
    trainer = Trainer(config, device=device).setup()
    assert trainer.world == mesh.World(rank=0, size=1)
    out = {"losses": []}
    batches = []
    device_batch = trainer._device_batch
    trainer._device_batch = lambda raw, world=None: (
        batches.append(device_batch(raw, world)) or batches[-1])
    before = copy.deepcopy(trainer.state)
    for step in range(2):
        out["losses"].append(trainer.train_iteration(step))
        if step == 0 and compare:
            ts = trainer.train_step
            plain = TrainStep(ts.cfg, trainer.train_cameras, trainer.aabb,
                              dict(config.optimizers), device,
                              model=config.pipeline.model_name,
                              camera_optimizer=ts.camera_optimizer)
            gen = torch.Generator(device=device).manual_seed(
                step_seed(config.machine.seed, 0, 0))
            want = plain.train_iteration(before, batches[0], gen)
            out["compare"] = (out["losses"][0], want,
                              [p.detach().clone()
                               for p in tree_leaves(trainer.state.params)],
                              tree_leaves(before.params))
    return out


@pytest.mark.parametrize("method", METHODS)
def test_force_shard_map_at_world_size_one(port_data, method, tmp_path):
    config = _port_config(port_data, method)
    compare = method == "k-planes-static"
    out = mesh.spawn(_world_one, 1, (config, compare), devices=["cpu"],
                     init_method=f"file://{tmp_path / 'store'}")[0]
    assert all(np.isfinite(float(m["Train Loss"])) for m in out["losses"])
    assert not mesh.current_world()
    if compare:
        got, want, params, plain_params = out["compare"]
        assert got.keys() == want.keys()
        assert all(torch.equal(got[k], want[k].to(got[k].dtype)) for k in got)
        assert all(torch.equal(a, b) for a, b in zip(params, plain_params))
