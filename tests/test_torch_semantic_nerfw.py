"""The port's semantic-nerfw (soccernerfs_tpu_torch/models/semantic_nerfw.py)
and its data path against the JAX package on the CPU: the semantic
compositor; the Sitcoms3D fixture, parser and semantic dataset (labels
equal, at full size and after a ``camera_res_scale_factor`` resize); the
labels through the image cache and the pixel sampler; one eval chunk's
semantic logits and labels; one whole train step (loss terms and every
gradient before the update) against ``jax.value_and_grad``; the registry
copy and the seeded params.

The JAX trainer's batches do not carry the labels (its cache collates
masks and depth maps only), so the JAX steps here take the batch's labels
directly; the port's cache and sampler carry them beside the image.

Small sizes: nerfacto at 3 levels and 16 wide, 5 classes, 96 rays.
Inputs are made with numpy from a seed; torch cannot reproduce JAX's PRNG
streams, so the steps take JAX's own jitter draws.  Every tolerance is
stated with its reason.
"""
import dataclasses
import functools
import random

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from soccernerfs_tpu.configs.method_configs import method_configs as jax_registry
from soccernerfs_tpu.core import camera_optimizer as jco
from soccernerfs_tpu.core import cameras as jcam
from soccernerfs_tpu.data import datasets as jds
from soccernerfs_tpu.data import fixtures as jfix
from soccernerfs_tpu.data import native_loader
from soccernerfs_tpu_torch.data import native_loader as tnative
from soccernerfs_tpu.data.datamanager import SemanticDataManagerConfig as JSemanticDM
from soccernerfs_tpu.data.dataparsers.sitcoms3d import (
    Sitcoms3DDataParserConfig as JSitcoms,
)
from soccernerfs_tpu.models import kplanes as jk
from soccernerfs_tpu.models import semantic_nerfw as jsem
from soccernerfs_tpu.ops import rendering as jrender
from soccernerfs_tpu_torch import convert
from soccernerfs_tpu_torch.configs import method_configs as tmc
from soccernerfs_tpu_torch.core import camera_optimizer as tco
from soccernerfs_tpu_torch.core import cameras as tcam
from soccernerfs_tpu_torch.data import datasets as tds
from soccernerfs_tpu_torch.data import fixtures as tfix
from soccernerfs_tpu_torch.data.datamanager import SemanticDataManagerConfig as TSemanticDM
from soccernerfs_tpu_torch.data.dataparsers import DATAPARSERS
from soccernerfs_tpu_torch.engine.trainer import Trainer, TrainStep
from soccernerfs_tpu_torch.models import get_model
from soccernerfs_tpu_torch.models import semantic_nerfw as tsem
from soccernerfs_tpu_torch.ops import rendering as trender

TSitcoms = DATAPARSERS["sitcoms3d-data"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch CPU thread while this file runs (the suite runs in
    parallel worker processes, whose default thread pools oversubscribe
    the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _no_native_loader(monkeypatch):
    """Both packages' data-path runtimes off (JAX's C++ loader, which its
    sampler and cache use when it loads, and the port's counterpart):
    both draw with numpy's choice and decode through their datasets."""
    monkeypatch.setattr(native_loader, "available", lambda: False)
    monkeypatch.setattr(tnative, "available", lambda: False)


CPU = "cpu"
AABB = np.array([[-1.5] * 3, [1.5] * 3], np.float32)
H = W = 8
N_RAYS = 96
N_CAMS = 3
N_CLASSES = 5
SMALL = dict(
    num_levels=3, max_res=64, log2_hashmap_size=13, hidden_dim=16,
    hidden_dim_color=16, num_proposal_samples_per_ray=(12, 8),
    num_nerf_samples_per_ray=6,
    proposal_net_args_list=(
        {"hidden_dim": 8, "log2_hashmap_size": 12, "num_levels": 3, "max_res": 32},
        {"hidden_dim": 8, "log2_hashmap_size": 12, "num_levels": 3, "max_res": 64},
    ),
    eval_num_rays_per_chunk=64, num_semantic_classes=N_CLASSES,
)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rel(got, want) -> float:
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


def _l2(got, want) -> float:
    got, want = _np(got), _np(want)
    return float(np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-30))


def _walk(tree, fn, path=()):
    if isinstance(tree, dict):
        return {k: _walk(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_walk(v, fn, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


# ---------------------------------------------------------------------------
# the compositor
# ---------------------------------------------------------------------------

def test_render_semantics_matches_jax():
    """The same f32 products and sums: within 1e-6 of the largest logit."""
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(32, 12, 7)).astype(np.float32)
    weights = rng.uniform(0, 0.1, (32, 12)).astype(np.float32)
    want = jrender.render_semantics(jnp.asarray(logits), jnp.asarray(weights))
    got = trender.render_semantics(_t(logits), _t(weights))
    assert got.shape == want.shape == (32, 7)
    assert _rel(got, want) <= 1e-6


# ---------------------------------------------------------------------------
# the data path
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sitcoms_root(tmp_path_factory):
    return jfix.make_sitcoms3d_fixture(tmp_path_factory.mktemp("sitcoms"),
                                       num_cameras=4, h=24, w=32)


def test_sitcoms3d_fixture_matches_jax(tmp_path, sitcoms_root):
    """The port's fixture writes JAX's files byte for byte."""
    mine = tfix.make_sitcoms3d_fixture(tmp_path / "s", num_cameras=4, h=24, w=32)
    theirs = sorted(p.relative_to(sitcoms_root) for p in sitcoms_root.rglob("*")
                    if p.is_file())
    assert theirs == sorted(p.relative_to(mine) for p in mine.rglob("*")
                            if p.is_file())
    assert len(theirs) == 10
    for rel in theirs:
        assert (mine / rel).read_bytes() == (sitcoms_root / rel).read_bytes(), rel


@pytest.mark.parametrize("split", ["train", "test"])
def test_sitcoms3d_parser_matches_jax(sitcoms_root, split):
    """Cameras, scene box, file names and the semantics metadata equal to
    the JAX parser's (the same f64 arithmetic, then f32)."""
    jout = JSitcoms(data=sitcoms_root).setup().get_dataparser_outputs(split)
    tout = TSitcoms(data=sitcoms_root).setup().get_dataparser_outputs(split)
    assert tout.image_filenames == jout.image_filenames
    for f in ("camera_to_worlds", "fx", "fy", "cx", "cy", "width", "height"):
        np.testing.assert_array_equal(_np(getattr(tout.cameras, f)),
                                      np.asarray(getattr(jout.cameras, f)), f)
    np.testing.assert_array_equal(_np(tout.scene_box.aabb),
                                  np.asarray(jout.scene_box.aabb))
    tsem_meta, jsem_meta = tout.metadata["semantics"], jout.metadata["semantics"]
    assert tsem_meta["filenames"] == jsem_meta["filenames"]
    assert tsem_meta["classes"] == jsem_meta["classes"] == ["class_0", "class_1",
                                                             "class_2"]
    np.testing.assert_array_equal(tsem_meta["colors"], jsem_meta["colors"])
    no_sem = TSitcoms(data=sitcoms_root, include_semantics=False).setup()
    assert "semantics" not in no_sem.get_dataparser_outputs(split).metadata


@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_semantic_dataset_labels_match_jax(sitcoms_root, scale):
    """The labels (int32 [H, W], Pillow's NEAREST resize at the scale) and
    images equal to the JAX dataset's; the ball and floor classes are
    there."""
    jout = JSitcoms(data=sitcoms_root).setup().get_dataparser_outputs("train")
    tout = TSitcoms(data=sitcoms_root).setup().get_dataparser_outputs("train")
    jd, td = jds.SemanticDataset(jout, scale), tds.SemanticDataset(tout, scale)
    assert len(td) == len(jd) == 4
    for i in range(4):
        a, b = jd[i], td[i]
        assert b["semantics"].dtype == np.int32
        assert b["semantics"].shape == (int(24 * scale), int(32 * scale))
        np.testing.assert_array_equal(b["semantics"], a["semantics"])
        np.testing.assert_array_equal(b["image"], a["image"])
    assert {1, 2} <= set(np.unique(td[0]["semantics"]).tolist())


def test_semantic_dataset_reads_the_first_channel_of_rgb_labels(tmp_path):
    """An RGB label image: the first channel, as JAX's dataset reads it."""
    root = tfix.make_sitcoms3d_fixture(tmp_path / "s", num_cameras=2, h=8, w=8)
    seg = root / "segmentations_4" / "thing" / "frame_0000.png"
    labels = np.asarray(Image.open(seg))
    Image.fromarray(np.stack([labels, labels + 7, labels * 0], -1)).save(seg)
    tout = TSitcoms(data=root).setup().get_dataparser_outputs("train")
    jout = JSitcoms(data=root).setup().get_dataparser_outputs("train")
    got = tds.SemanticDataset(tout)[0]["semantics"]
    np.testing.assert_array_equal(got, labels.astype(np.int32))
    np.testing.assert_array_equal(got, jds.SemanticDataset(jout)[0]["semantics"])


def test_semantic_batches_through_cache_and_sampler(sitcoms_root):
    """semantic-nerfw's datamanager at JAX's seeds: the same pixel draws
    and colours as JAX's batches, train and eval, and each batch's
    "semantics" [N] int32 are the labels of the dataset at the drawn
    pixels; the Trainer's device batch keeps them int32."""
    common = dict(train_num_rays_per_batch=64, eval_num_rays_per_batch=32)
    random.seed(5)
    j = JSemanticDM(dataparser=JSitcoms(data=sitcoms_root), **common).setup(seed=5)
    t = TSemanticDM(dataparser=TSitcoms(data=sitcoms_root), **common).setup(
        seed=5, device=CPU)
    labels = np.stack([t.train_dataset[i]["semantics"] for i in range(4)])
    for step in range(3):
        for name in ("next_train_raw", "next_eval_raw"):
            a, b = getattr(j, name)(step), getattr(t, name)(step)
            assert set(b) == set(a) | {"semantics"}, name
            for k in a:
                np.testing.assert_array_equal(b[k], a[k], err_msg=f"{name} {k}")
            idx = b["indices"]
            assert b["semantics"].dtype == np.int32
            np.testing.assert_array_equal(
                b["semantics"], labels[idx[:, 0], idx[:, 1], idx[:, 2]])
    dev = Trainer.__new__(Trainer)
    dev.device = torch.device(CPU)
    batch = Trainer._device_batch(dev, t.next_train_raw(3))
    assert batch["semantics"].dtype == torch.int32
    assert batch["semantics"].shape == (64,)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _camera_args():
    c2w = np.tile(np.eye(3, 4, dtype=np.float32)[None], (N_CAMS, 1, 1))
    c2w[:, :, 3] = [[0.2, -0.1, 3.0], [-0.3, 0.2, 2.8], [0.0, 0.1, 3.2]]
    return dict(camera_to_worlds=c2w, fx=7.0, fy=7.5, cx=4.1, cy=3.9,
                width=W, height=H)


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {
        "cam_idx": rng.integers(0, N_CAMS, N_RAYS).astype(np.int32),
        "coords": rng.uniform(0, H, (N_RAYS, 2)).astype(np.float32),
        "image": rng.uniform(0, 1, (N_RAYS, 3)).astype(np.float32),
        "semantics": rng.integers(0, N_CLASSES, N_RAYS).astype(np.int32),
    }


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = jsem.Config(**SMALL), tsem.Config(**SMALL)

    def lift(path, x):
        # the init's tables are U(-1e-4, 1e-4): scale them to +-0.3 so the
        # encoding shapes densities, features and gradients
        x = np.asarray(x)
        return x * 3000.0 if path[-1] == "embeddings" else x

    np_tree = _walk(jax.tree_util.tree_map(
        np.asarray, jsem.init(jax.random.PRNGKey(0), jcfg, N_CAMS)), lift)
    jcams = jcam.Cameras.create(**_camera_args())
    step = 300

    @jax.jit
    def jax_step(params, batch, key):
        def loss_fn(p):
            rays = jcam.generate_rays(jcams, batch["cam_idx"], batch["coords"])
            outputs = jsem.get_outputs(
                jcfg, p, jnp.asarray(AABB), rays, rng=key, train=True,
                anneal=jk.proposal_anneal(jcfg, step), train_proposal_networks=True)
            metrics = jsem.get_metrics_dict(jcfg, outputs, batch, step)
            ld = jsem.get_loss_dict(jcfg, p, outputs, batch, metrics, train=True)
            return functools.reduce(jnp.add, ld.values()), (ld, metrics)

        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    @jax.jit
    def jax_eval(params, batch):
        rays = jcam.generate_rays(jcams, batch["cam_idx"], batch["coords"])
        out = jsem.get_outputs(jcfg, params, jnp.asarray(AABB), rays, rng=None,
                               train=False)
        return {k: out[k] for k in ("rgb", "accumulation", "depth", "semantics",
                                    "semantics_labels")}

    return dict(jcfg=jcfg, tcfg=tcfg, np_tree=np_tree, jax_step=jax_step,
                jax_eval=jax_eval, step=step)


def _port_rays(batch):
    cams = tcam.Cameras.create(**_camera_args(), device=CPU)
    return tcam.generate_rays(cams, _t(batch["cam_idx"]), _t(batch["coords"]))


def _jitters(key, cfg):
    """The JAX forward's draws: nerfacto's get_outputs splits its key into
    (sampler, background); the proposal sampler splits its own into one
    key per level, each a single jitter [N, 1]."""
    rng_sample, _ = jax.random.split(key)
    keys = jax.random.split(rng_sample, cfg.num_proposal_iterations + 1)
    return [_t(jax.random.uniform(k, (N_RAYS, 1))) for k in keys]


def test_eval_chunk_semantics_match_jax(setup):
    """One eval chunk: the composited logits within 1e-4 of their largest
    value (bf16 MLP operands on both sides, the same roundings but for f32
    sums in another order); the labels equal wherever the top two logits
    lie more than 1e-4 apart; rgb and accumulation within 1e-4."""
    tcfg = setup["tcfg"]
    batch = _batch(2)
    want = setup["jax_eval"](jax.tree_util.tree_map(jnp.asarray, setup["np_tree"]),
                             {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        got = tsem.get_outputs(tcfg, convert.params_from_jax(setup["np_tree"], CPU),
                               _t(AABB), _port_rays(batch), train=False)
    assert got["semantics"].shape == (N_RAYS, N_CLASSES)
    for k in ("semantics", "rgb", "accumulation"):
        assert _rel(got[k], want[k]) <= 1e-4, (k, _rel(got[k], want[k]))
    top2 = np.sort(np.asarray(want["semantics"]), axis=-1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 1e-4
    assert clear.mean() > 0.5
    assert got["semantics_labels"].dtype == torch.int64
    np.testing.assert_array_equal(_np(got["semantics_labels"])[clear],
                                  np.asarray(want["semantics_labels"])[clear])


@pytest.mark.parametrize("seed", [0, 1])
def test_train_step_matches_jax(setup, seed):
    """One whole train step at step 300 against jax.value_and_grad with
    the same params, batch (with labels) and draws: the loss, each term
    (nerfacto's three and the semantic cross-entropy) and psnr within
    1e-4 relative; every gradient leaf within 1e-2 in L2 (ROADMAP C.7: the
    bf16 MLP policy flips single roundings).  The semantic loss reaches
    mlp_semantics only: the grids and the other MLPs get no gradient from
    it (geo features and weights detached)."""
    tcfg = setup["tcfg"]
    batch = _batch(seed)
    key = jax.random.PRNGKey(11 + seed)
    (jloss, (jld, jmet)), jgrads = setup["jax_step"](
        jax.tree_util.tree_map(jnp.asarray, setup["np_tree"]),
        {k: jnp.asarray(v) for k, v in batch.items()}, key)
    trainer = TrainStep(
        tcfg, tcam.Cameras.create(**_camera_args(), device=CPU), AABB,
        tmc.optimizer_configs["semantic-nerfw"], device=CPU,
        model="semantic_nerfw",
        camera_optimizer=tmc.camera_optimizer_configs["semantic-nerfw"])
    state = trainer.init_state(convert.params_from_jax(setup["np_tree"], CPU))
    state.step = setup["step"]
    loss, ld, met, grads = trainer.loss_and_grads(
        state, {k: _t(v) for k, v in batch.items()}, train_proposal_networks=True,
        jitters=_jitters(key, tcfg))
    assert list(ld) == ["rgb_loss", "interlevel_loss", "distortion_loss",
                        "semantics_loss"]
    assert set(jld) == set(ld) and set(jmet) == set(met)
    assert _rel(loss, jloss) <= 1e-4
    for k in jld:
        assert _rel(ld[k], jld[k]) <= 1e-4, k
    for k in jmet:
        assert _rel(met[k], jmet[k]) <= 1e-4, k
    names = []
    _walk(state.params, lambda path, x: names.append(path))
    tgrads = dict(zip(names, grads))
    jflat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert len(jflat) == len(names)
    for path, jg in jflat:
        name = tuple(p.key if hasattr(p, "key") else p.idx for p in path)
        g = tgrads[name]
        assert g is not None and tuple(g.shape) == jg.shape, name
        assert _l2(g, jg) <= 1e-2, (name, _l2(g, jg))

    # the semantic loss alone
    outputs = tsem.get_outputs(
        tcfg, state.params, _t(AABB), _port_rays(batch), train=True,
        anneal=tsem.proposal_anneal(tcfg, state.step), jitters=_jitters(key, tcfg))
    sem = tsem.get_loss_dict(tcfg, state.params, outputs,
                             {k: _t(v) for k, v in batch.items()},
                             tsem.get_metrics_dict(tcfg, outputs, {
                                 "image": _t(batch["image"])}))["semantics_loss"]
    leaves = [(n, x) for n, x in zip(names, _flat(state.params))]
    sgrads = torch.autograd.grad(sem, [x for _n, x in leaves], allow_unused=True)
    for (n, _x), g in zip(leaves, sgrads):
        if n[:2] == ("fields", "mlp_semantics"):
            assert g is not None and float(g.abs().max()) > 0.0, n
        else:
            assert g is None or float(g.abs().max()) == 0.0, n


def test_train_step_with_the_camera_optimizer_matches_jax(setup):
    """The step above with the SO3xR3 camera optimizer on and non-zero pose
    adjustments: the loss terms within 1e-4 relative and every gradient
    leaf, the pose's included, within 1e-2 in L2 (the tolerances above),
    against jax.value_and_grad of the JAX Trainer's loss_fn."""
    jcfg, tcfg, step = setup["jcfg"], setup["tcfg"], setup["step"]
    rng = np.random.default_rng(31)
    np_tree = dict(setup["np_tree"], camera_opt={"pose_adjustment": (
        rng.standard_normal((N_CAMS, 6)) * 0.02).astype(np.float32)})
    jcams = jcam.Cameras.create(**_camera_args())
    jcam_cfg = jco.CameraOptimizerConfig(mode="SO3xR3")
    batch = _batch(4)
    key = jax.random.PRNGKey(23)

    @jax.jit
    def jax_step(params, batch):
        def loss_fn(p):
            cam_opt = jco.apply_camera_optimizer(jcam_cfg, p["camera_opt"],
                                                 batch["cam_idx"])
            rays = jcam.generate_rays(jcams, batch["cam_idx"], batch["coords"],
                                      cam_opt)
            outputs = jsem.get_outputs(
                jcfg, p, jnp.asarray(AABB), rays, rng=key, train=True,
                anneal=jk.proposal_anneal(jcfg, step), train_proposal_networks=True)
            metrics = jsem.get_metrics_dict(jcfg, outputs, batch, step)
            ld = jsem.get_loss_dict(jcfg, p, outputs, batch, metrics, train=True)
            return functools.reduce(jnp.add, ld.values()), ld

        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    (jloss, jld), jgrads = jax_step(
        jax.tree_util.tree_map(jnp.asarray, np_tree),
        {k: jnp.asarray(v) for k, v in batch.items()})
    groups = dict(tmc.optimizer_configs["semantic-nerfw"],
                  camera_opt=tmc.optimizer_configs["nerfacto"]["camera_opt"])
    trainer = TrainStep(
        tcfg, tcam.Cameras.create(**_camera_args(), device=CPU), AABB, groups,
        device=CPU, model="semantic_nerfw",
        camera_optimizer=tco.CameraOptimizerConfig(mode="SO3xR3"))
    state = trainer.init_state(convert.params_from_jax(np_tree, CPU))
    state.step = step
    loss, ld, _met, grads = trainer.loss_and_grads(
        state, {k: _t(v) for k, v in batch.items()}, train_proposal_networks=True,
        jitters=_jitters(key, tcfg))
    assert set(jld) == set(ld)
    assert _rel(loss, jloss) <= 1e-4
    for k in jld:
        assert _rel(ld[k], jld[k]) <= 1e-4, k
    names = []
    _walk(state.params, lambda path, x: names.append(path))
    tgrads = dict(zip(names, grads))
    jflat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert len(jflat) == len(names)
    for path, jg in jflat:
        name = tuple(p.key if hasattr(p, "key") else p.idx for p in path)
        g = tgrads[name]
        assert g is not None and tuple(g.shape) == jg.shape, name
        assert _l2(g, jg) <= 1e-2, (name, _l2(g, jg))
    assert float(tgrads[("camera_opt", "pose_adjustment")].abs().max()) > 0


def _flat(tree):
    out = []
    _walk(tree, lambda path, x: out.append(x))
    return out


def test_pass_semantic_gradients_reaches_the_grid():
    """With ``pass_semantic_gradients`` the semantic loss reaches the main
    grid and mlp_base through the geo features, as in JAX."""
    cfg = tsem.Config(**SMALL, pass_semantic_gradients=True)
    params = tsem.init(cfg, N_CAMS, torch.Generator().manual_seed(0), CPU)
    grid = params["fields"]["grid"]["embeddings"]
    with torch.no_grad():
        grid.mul_(3000.0)
    for leaf in _flat(params):
        leaf.requires_grad_(True)
    batch = _batch(3)
    jit = [torch.rand((N_RAYS, 1), generator=torch.Generator().manual_seed(i))
           for i in range(3)]
    out = tsem.get_outputs(cfg, params, _t(AABB), _port_rays(batch), train=True,
                           jitters=jit)
    sem = tsem.get_loss_dict(cfg, params, out, {k: _t(v) for k, v in batch.items()},
                             tsem.get_metrics_dict(cfg, out, {"image": _t(batch["image"])})
                             )["semantics_loss"]
    (g,) = torch.autograd.grad(sem, [grid])
    assert float(g.abs().max()) > 0.0


def test_registry_copy_and_seeded_params():
    """The port's semantic-nerfw: JAX's model config field by field, the two
    Adam groups (lr 1e-2, eps 1e-15, no schedule), 4096 rays, the
    Sitcoms3D parser behind the semantic datamanager; seeded_params and
    the torch init have JAX's tree (mlp_semantics: geo features -> 64 x 1
    -> classes)."""
    port, jcfg = tmc.trainer_configs["semantic-nerfw"], jax_registry["semantic-nerfw"]
    assert (dataclasses.asdict(port.pipeline.model)
            == dataclasses.asdict(jcfg.pipeline.model))
    assert port.pipeline.model.eval_num_rays_per_chunk == 1 << 16
    assert set(port.optimizers) == set(jcfg.optimizers) == {"proposal_networks",
                                                            "fields"}
    for name, group in port.optimizers.items():
        jgroup = jcfg.optimizers[name]
        assert (group["optimizer"].lr, group["optimizer"].eps) == (
            jgroup["optimizer"].lr, jgroup["optimizer"].eps) == (1e-2, 1e-15)
        assert group["scheduler"] is None and jgroup["scheduler"] is None
    dm, jdm = port.pipeline.datamanager, jcfg.pipeline.datamanager
    assert type(dm).__name__ == type(jdm).__name__ == "SemanticDataManagerConfig"
    assert type(dm.dataparser).__name__ == "Sitcoms3DDataParserConfig"
    assert (dm.train_num_rays_per_batch, dm.eval_num_rays_per_batch) == (4096, 8192)
    assert dm.camera_optimizer.mode == jdm.camera_optimizer.mode == "off"
    assert get_model("semantic_nerfw") is tsem
    small = tsem.Config(**SMALL)
    want = jax.tree_util.tree_map(lambda a: a.shape,
                                  jsem.init(jax.random.PRNGKey(0), jsem.Config(**SMALL),
                                            N_CAMS))
    assert jax.tree_util.tree_map(lambda a: a.shape,
                                  convert.seeded_params(small, 0, N_CAMS)) == want
    init = tsem.init(small, N_CAMS, torch.Generator().manual_seed(0), CPU)
    assert jax.tree_util.tree_map(lambda a: tuple(a.shape), init) == want
