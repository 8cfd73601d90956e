"""The port's Trainer: checkpoints and resume (a copy of
tests/test_resume.py's two tests), the train loop's contracts (the
deferred range check where values are read, dynamic_batch against the JAX
trainer's arithmetic, CUDA by default), the
``trainer_configs`` registry against the JAX one field by field, the
config file, the convergence gate (slow), and that no module of the port
imports JAX or the JAX package.
"""
import ast
import copy
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from soccernerfs_tpu.configs.method_configs import method_configs as jax_registry
from soccernerfs_tpu_torch.configs import method_configs as mc
from soccernerfs_tpu_torch.data.dataparsers.blender import BlenderDataParserConfig
from soccernerfs_tpu_torch.data.fixtures import make_blender_fixture
from soccernerfs_tpu_torch.engine import checkpoints as ckpt
from soccernerfs_tpu_torch.engine import trainer as trainer_mod
from soccernerfs_tpu_torch.engine.trainer import (
    Trainer,
    dynamic_batch_update,
    step_check,
)
from soccernerfs_tpu_torch.ops.kernels import scatter_kernels
from soccernerfs_tpu_torch.pipelines import average_eval_image_metrics
from soccernerfs_tpu_torch.utils.tree import tree_leaves

REPO = Path(__file__).resolve().parents[1]
N = 3  # resume point; the full run is 2N steps

# tests/test_resume.py's narrow nerfacto
SMALL = dict(
    num_levels=3, max_res=32, log2_hashmap_size=9,
    num_proposal_samples_per_ray=(8, 6), num_nerf_samples_per_ray=4,
    hidden_dim=16, hidden_dim_color=16,
    proposal_net_args_list=(
        {"hidden_dim": 8, "log2_hashmap_size": 9, "num_levels": 3, "max_res": 16},
        {"hidden_dim": 8, "log2_hashmap_size": 9, "num_levels": 3, "max_res": 32},
    ),
)
SMALL_KPLANES = dict(
    spacetime_resolution=(8, 8, 8), multiscale_res=(1, 2), feature_dim=8,
    num_proposal_samples_per_ray=(8, 6), num_nerf_samples_per_ray=4,
    sigma_net_hidden_dim=16, rgb_net_hidden_dim=16,
    proposal_net_args_list=({"feature_dim": 8, "resolution": (8, 8, 8)},
                            {"feature_dim": 8, "resolution": (16, 16, 16)}),
    eval_num_rays_per_chunk=256,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch CPU thread while this file runs (the suite runs in
    parallel worker processes, whose default thread pools oversubscribe
    the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def blender_root(tmp_path_factory):
    return make_blender_fixture(tmp_path_factory.mktemp("blender"), h=12, w=16)


def _config(tmp_path, blender_root, name, method="nerfacto", load_dir=None,
            **model):
    cfg = copy.deepcopy(mc.trainer_configs[method])
    cfg.pipeline.model = dataclasses.replace(
        cfg.pipeline.model, **(model or (SMALL if method == "nerfacto"
                                         else SMALL_KPLANES)))
    dm = cfg.pipeline.datamanager
    dm.train_num_rays_per_batch = 32
    dm.eval_num_rays_per_batch = 16
    dm.train_num_images_to_sample_from = -1
    dm.eval_num_images_to_sample_from = -1
    dm.dataparser = BlenderDataParserConfig(data=blender_root)
    cfg.max_num_iterations = 2 * N
    cfg.steps_per_save = 0
    cfg.steps_per_eval_batch = 0
    cfg.steps_per_eval_image = 0
    cfg.steps_per_eval_all_images = 0
    cfg.vis = "none"
    cfg.output_dir = tmp_path / name
    cfg.set_timestamp()
    cfg.load_dir = load_dir
    return cfg


def _make_trainer(tmp_path, blender_root, name, **kw):
    return Trainer(_config(tmp_path, blender_root, name, **kw), device="cpu").setup()


def _run_steps(trainer, steps):
    losses = []
    for step in steps:
        # identical host batches across runs: both the uninterrupted and
        # the resumed trainer draw from a per-step-seeded sampler
        trainer.datamanager.train_pixel_sampler.rng = np.random.default_rng(
            9000 + step)
        metrics = trainer.train_iteration(step)
        losses.append(float(metrics["Train Loss"]))
    return losses


def _assert_states_equal(a, b):
    assert a.step == b.step and a.steps_since_update == b.steps_since_update
    for x, y in zip(tree_leaves(a.params), tree_leaves(b.params), strict=True):
        assert x.dtype == y.dtype and torch.equal(x.detach(), y.detach())
    assert a.opt_state.keys() == b.opt_state.keys()
    for name, o in a.opt_state.items():
        p = b.opt_state[name]
        assert o.count == p.count
        for x, y in zip(o.mu + o.nu, p.mu + p.nu, strict=True):
            assert x.dtype == y.dtype and torch.equal(x, y)
    assert a.aux.keys() == b.aux.keys()
    for k in a.aux:
        assert torch.equal(a.aux[k], b.aux[k])


def test_resume_matches_uninterrupted(tmp_path, blender_root):
    full = _make_trainer(tmp_path, blender_root, "full")
    loss_full = _run_steps(full, range(2 * N))

    first = _make_trainer(tmp_path, blender_root, "first")
    loss_first = _run_steps(first, range(N))
    first.save_checkpoint(N - 1)
    np.testing.assert_allclose(loss_first, loss_full[:N], rtol=1e-6)

    resumed = _make_trainer(tmp_path, blender_root, "resumed",
                            load_dir=first.base_dir)
    # the step resumes after the checkpointed one; the round trip is exact
    assert resumed.state.step == N
    _assert_states_equal(resumed.state, first.state)
    assert "camera_opt" in resumed.state.params

    loss_resumed = _run_steps(resumed, range(N, 2 * N))
    np.testing.assert_allclose(loss_resumed, loss_full[N:], rtol=1e-6, atol=1e-7)
    for a, b in zip(tree_leaves(resumed.state.params),
                    tree_leaves(full.state.params), strict=True):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-6, atol=1e-6)


def test_resume_via_train_loop(tmp_path, blender_root):
    """train() honours the start step: a resumed trainer runs only the
    remaining steps and writes the final checkpoint."""
    first = _make_trainer(tmp_path, blender_root, "loop_first")
    first.config.max_num_iterations = N
    first.train()
    assert ckpt.latest_checkpoint_step(first.base_dir) == N - 1

    resumed = _make_trainer(tmp_path, blender_root, "loop_resumed",
                            load_dir=first.base_dir)
    assert resumed.state.step == N
    resumed.train()
    assert resumed.state.step == 2 * N
    assert ckpt.latest_checkpoint_step(resumed.base_dir) == 2 * N - 1


def test_kplanes_checkpoint_round_trip(tmp_path, blender_root):
    """K-Planes' bf16 first moments and the proposal schedule's counter
    survive a checkpoint bit for bit; save_only_latest keeps one file."""
    cfg = _config(tmp_path, blender_root, "kp", method="k-planes-static")
    cfg.save_only_latest_checkpoint = True
    cfg.max_num_iterations = 4
    cfg.steps_per_save = 2
    trainer = Trainer(cfg, device="cpu").setup()
    trainer.train()
    files = sorted(p.name for p in ckpt.checkpoint_dir(trainer.base_dir).iterdir())
    assert files == ["step-000000003.pt"]
    step, saved = ckpt.load_checkpoint(trainer.base_dir)
    assert step == 3 and saved["step"] == 4
    assert {m.dtype for o in saved["opt_state"].values() for m in o["mu"]} == {
        torch.bfloat16}
    resumed = Trainer(_config(tmp_path, blender_root, "kp2", method="k-planes-static",
                              load_dir=trainer.base_dir), device="cpu").setup()
    _assert_states_equal(resumed.state, trainer.state)
    with pytest.raises(FileNotFoundError):
        ckpt.load_checkpoint(tmp_path / "nowhere")


def test_camera_optimizer_trains_kplanes_and_undetaches_the_encodes(
        tmp_path, blender_root, capsys):
    """With the SO3xR3 camera optimizer on, k-planes trains through
    Trainer.train (4 steps): the poses move, and the checkpoint carries
    ``camera_opt`` and its optimizer state, which a resumed Trainer loads
    bit for bit.  A NeRFPlayer method's Trainer turns its
    ``detached_inputs`` off on its own model config, as the JAX Trainer
    does, prints the JAX Trainer's notice, leaves the saved config as
    given and trains a step whose pose adjustments move."""
    from soccernerfs_tpu_torch.core.camera_optimizer import CameraOptimizerConfig

    so3 = CameraOptimizerConfig(mode="SO3xR3")
    cfg = _config(tmp_path, blender_root, "kp_so3", method="k-planes")
    cfg.pipeline.datamanager.camera_optimizer = so3
    cfg.max_num_iterations = 4
    cfg.steps_per_save = 2
    trainer = Trainer(cfg, device="cpu").setup()
    before = trainer.state.params["camera_opt"]["pose_adjustment"].detach().clone()
    trainer.train()
    after = trainer.state.params["camera_opt"]["pose_adjustment"]
    assert bool(torch.isfinite(after).all()) and not torch.equal(before, after)
    _step, saved = ckpt.load_checkpoint(trainer.base_dir)
    assert "camera_opt" in saved["opt_state"]
    resumed = Trainer(_config(tmp_path, blender_root, "kp_so3b", method="k-planes",
                              load_dir=trainer.base_dir), device="cpu")
    resumed.config.pipeline.datamanager.camera_optimizer = so3
    resumed.setup()
    _assert_states_equal(resumed.state, trainer.state)

    root = make_blender_fixture(tmp_path / "dnerf", h=12, w=16, with_times=True)
    cfg = copy.deepcopy(mc.trainer_configs["nerfplayer-nerfacto"])
    cfg.pipeline.model = dataclasses.replace(
        cfg.pipeline.model, num_levels=2, log2_hashmap_size=8, temporal_dim=8,
        num_proposal_samples_per_ray=(8, 6), num_nerf_samples_per_ray=4,
        hidden_dim=16, hidden_dim_color=16, proposal_net_args_list=(
            {"hidden_dim": 8, "log2_hashmap_size": 8, "num_levels": 2,
             "max_res": 16, "temporal_dim": 8},
            {"hidden_dim": 8, "log2_hashmap_size": 8, "num_levels": 2,
             "max_res": 32, "temporal_dim": 8}))
    dm = cfg.pipeline.datamanager
    dm.camera_optimizer = so3
    dm.train_num_rays_per_batch = 32
    dm.eval_num_rays_per_batch = 16
    dm.train_num_images_to_sample_from = -1
    dm.eval_num_images_to_sample_from = -1
    from soccernerfs_tpu_torch.data.dataparsers import DATAPARSERS

    dm.dataparser = DATAPARSERS["dnerf-data"](data=root)
    cfg.vis = "none"
    cfg.output_dir = tmp_path / "np_so3"
    cfg.set_timestamp()
    capsys.readouterr()
    trainer = Trainer(cfg, device="cpu").setup()
    assert "enabling encode input gradients" in capsys.readouterr().out
    assert trainer.model_cfg.detached_inputs is False
    assert trainer.train_step.cfg.detached_inputs is False
    assert cfg.pipeline.model.detached_inputs is True
    before = trainer.state.params["camera_opt"]["pose_adjustment"].detach().clone()
    trainer.train_iteration(0)
    trainer.train_iteration(1)
    after = trainer.state.params["camera_opt"]["pose_adjustment"]
    assert bool(torch.isfinite(after).all()) and not torch.equal(before, after)


def test_generator_is_seeded_per_step():
    a = trainer_mod.step_seed(42, 7)
    assert a == trainer_mod.step_seed(42, 7)
    assert len({a, trainer_mod.step_seed(42, 8), trainer_mod.step_seed(43, 7)}) == 3


def _jax_dynamic_batch(cur, num_samples, target_samples, base_rays, db_lg):
    """soccernerfs_tpu/engine/trainer.py's dynamic_batch arithmetic
    (Trainer.train), verbatim but for the names."""
    num_samples = max(float(num_samples), 1.0)
    desired = cur * target_samples / num_samples
    lg = float(np.log2(desired))
    db_lg = lg if db_lg is None else 0.7 * db_lg + 0.3 * lg
    bucket = int(2 ** np.clip(np.round(db_lg), 6, np.log2(base_rays * 4)))
    if bucket != cur and abs(db_lg - np.log2(cur)) > 0.75:
        cur = bucket
    return cur, db_lg


def test_dynamic_batch_matches_jax():
    rng = np.random.default_rng(0)
    # a warm-up drop in samples per ray, noise at a bucket's edge, a jump
    per_ray = np.concatenate([np.full(5, 48.0), np.full(10, 12.0),
                              24 + rng.normal(0, 2, 30), np.full(10, 96.0),
                              np.zeros(3)])
    seq = {}
    for impl in ("port", "jax"):
        cur, lg, out = 8192, None, []
        for spr in per_ray:
            samples = cur * spr
            if impl == "port":
                cur, lg = dynamic_batch_update(cur, samples, 1 << 18, 8192, lg)
            else:
                cur, lg = _jax_dynamic_batch(cur, samples, 1 << 18, 8192, lg)
            out.append((cur, lg))
        seq[impl] = out
    assert seq["port"] == seq["jax"]
    sizes = [c for c, _ in seq["port"]]
    assert len(set(sizes)) >= 3 and max(sizes) <= 4 * 8192 and min(sizes) >= 64


def test_step_check():
    assert [s for s in range(10) if step_check(s, 3)] == [3, 6, 9]
    assert step_check(0, 3, run_at_zero=True) and not step_check(5, 0)


def test_range_check_where_values_are_read(tmp_path, blender_root, monkeypatch):
    """Every host read of a step's values (the logs, the eval batches)
    and every checkpoint comes after scatter_kernels.raise_if_out_of_range."""
    events = []
    check = scatter_kernels.raise_if_out_of_range

    def spy(device=None):
        events.append(("check", sys._getframe(1).f_code.co_name))
        return check(device)

    monkeypatch.setattr(scatter_kernels, "raise_if_out_of_range", spy)
    real_save = ckpt.save_checkpoint
    monkeypatch.setattr(ckpt, "save_checkpoint",
                        lambda *a, **k: (events.append(("save", None)),
                                         real_save(*a, **k))[1])
    cfg = _config(tmp_path, blender_root, "spy")
    cfg.logging.steps_per_log = 2
    cfg.steps_per_eval_batch = 3
    cfg.steps_per_save = 4
    trainer = Trainer(cfg, device="cpu").setup()
    trainer.train()
    reads = [e for e in events if e == ("check", "_read")]
    # logs at steps 0, 2, 4; eval batches at 3
    assert len(reads) == 3 + 1
    saves = [i for i, e in enumerate(events) if e[0] == "save"]
    assert len(saves) == 2  # step 4 and the final one
    for i in saves:
        assert events[i - 1] == ("check", "save_checkpoint")


def test_dynamic_batch_reads_after_range_check(tmp_path, blender_root, monkeypatch):
    """dynamic_batch reads each step's sample count on the host: behind the
    range check, and the sampler's size follows dynamic_batch_update."""
    seen = []
    monkeypatch.setattr(scatter_kernels, "raise_if_out_of_range",
                        lambda device=None: seen.append(sys._getframe(1).f_code.co_name))
    cfg = _config(tmp_path, blender_root, "dyn")
    cfg.pipeline.dynamic_batch = True
    cfg.pipeline.target_num_samples = 1 << 12
    cfg.logging.steps_per_log = 100
    trainer = Trainer(cfg, device="cpu").setup()
    counts = []
    real = trainer.train_step.train_iteration

    def with_samples(state, batch, generator):
        m = real(state, batch, generator)
        counts.append((batch["cam_idx"].shape[0], 64.0 * batch["cam_idx"].shape[0]))
        return {**m, "num_samples_per_batch": torch.tensor(counts[-1][1])}

    trainer.train_step.train_iteration = with_samples
    trainer.train()
    assert seen.count("_read") == 2 * N + 1  # every step, and the log at 0
    cur, lg = 32, None
    for rays, samples in counts:
        assert rays == cur
        cur, lg = dynamic_batch_update(cur, samples, 1 << 12, 32, lg)


def test_cuda_by_default_and_host_update_refused(tmp_path, blender_root,
                                                 monkeypatch):
    """CUDA by default (raises without it); a model's ``host_update`` is
    called before each step with the step and the optimizer-state
    factory, and a state it returns is the one the step trains (no longer
    refused: TensoRF upsamples through it)."""
    cfg = _config(tmp_path, blender_root, "dev")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            Trainer(cfg)
    from soccernerfs_tpu_torch.models import nerfacto

    calls, replaced = [], []

    def host_update(model_cfg, state, step, init_opt_state):
        calls.append(step)
        if step != 1:
            return None
        params = {k: {n: v for n, v in g.items()} if isinstance(g, dict) else g
                  for k, g in state.params.items()}
        new = dataclasses.replace(state, params=params,
                                  opt_state=init_opt_state(params))
        replaced.append(new)
        return new

    monkeypatch.setattr(nerfacto, "host_update", host_update, raising=False)
    trainer = Trainer(cfg, device="cpu").setup()
    _run_steps(trainer, range(3))
    assert calls == [0, 1, 2]
    assert trainer.state is replaced[0] and trainer.state.step == 3
    # the fresh optimizer state counted the two steps after the swap
    assert {o.count for o in trainer.state.opt_state.values()} == {2}


def test_setup_writes_config_and_transform(tmp_path, blender_root):
    trainer = _make_trainer(tmp_path, blender_root, "files")
    import yaml

    saved = yaml.load((trainer.base_dir / "config.yml").read_text(),
                      Loader=yaml.Loader)
    assert saved == trainer.config
    assert type(saved).__name__ == "TrainerConfig" and saved.method_name == "nerfacto"
    assert saved.pipeline.model.num_levels == 3
    assert isinstance(saved.pipeline.datamanager.dataparser, BlenderDataParserConfig)
    transform = json.loads((trainer.base_dir / "dataparser_transforms.json").read_text())
    assert transform["scale"] == 1.0


def test_eval_surface(tmp_path, blender_root):
    """Eval batch losses, an eval image and every eval image (at the
    trained state), and the averaged metrics with lpips as None."""
    trainer = _make_trainer(tmp_path, blender_root, "eval", method="k-planes-static")
    trainer.train_iteration(0)
    losses = {k: float(v) for k, v in trainer.eval_iteration(0).items()}
    assert "rgb_loss" in losses and np.isfinite(list(losses.values())).all()
    image = trainer.eval_image(0)
    assert np.isfinite(image["psnr"]) and image["image_idx"] == 0
    all_images = trainer.eval_all_images(0)
    assert np.isfinite(all_images["psnr"]) and all_images["fps"] > 0
    avg = average_eval_image_metrics(trainer)
    assert avg["lpips"] is None and 0 < avg["ssim"] <= 1


def _fields(x):
    return {f.name: getattr(x, f.name) for f in dataclasses.fields(x)}


def _same_config(port, jax_cfg, where):
    """Every field of the port's config equals the JAX one's; a field the
    port lacks must hold its default on the JAX side."""
    pf, jf = _fields(port), _fields(jax_cfg)
    for name, value in pf.items():
        assert name in jf, f"{where}.{name}"
        if dataclasses.is_dataclass(value):  # a nested config (neus's SDF field)
            _same_config(value, jf[name], f"{where}.{name}")
            continue
        assert value == jf[name], f"{where}.{name}: {value} != {jf[name]}"
    defaults = {f.name: f.default for f in dataclasses.fields(jax_cfg)}
    for name in set(jf) - set(pf):
        assert jf[name] == defaults[name], f"{where}.{name} is not ported"


@pytest.mark.parametrize("method", sorted(mc.trainer_configs))
def test_trainer_configs_match_jax_registry(method):
    port, jax_cfg = mc.trainer_configs[method], jax_registry[method]
    for name in ("method_name", "steps_per_save", "steps_per_eval_batch",
                 "steps_per_eval_image", "steps_per_eval_all_images",
                 "max_num_iterations", "mixed_precision",
                 "save_only_latest_checkpoint", "vis", "timestamp",
                 "output_dir", "load_dir", "load_step"):
        assert getattr(port, name) == getattr(jax_cfg, name), name
    for part in ("viewer", "logging"):
        assert _fields(getattr(port, part)) == _fields(getattr(jax_cfg, part))
    jm = _fields(jax_cfg.machine)
    assert {k: jm[k] for k in _fields(port.machine)} == _fields(port.machine)
    pp, jp = port.pipeline, jax_cfg.pipeline
    for name in ("model_name", "dynamic_batch", "target_num_samples",
                 "max_num_samples_per_ray"):
        assert getattr(pp, name) == getattr(jp, name), name
    _same_config(pp.model, jp.model, "model")
    pdm, jdm = _fields(pp.datamanager), _fields(jp.datamanager)
    assert type(pp.datamanager).__name__ == type(jp.datamanager).__name__
    assert pdm.keys() == jdm.keys()
    for name in pdm:
        if name == "dataparser":
            assert type(pdm[name]).__name__ == type(jdm[name]).__name__
            assert _fields(pdm[name]) == _fields(jdm[name])
        elif name == "camera_optimizer":
            assert _fields(pdm[name]) == _fields(jdm[name])
        else:
            assert pdm[name] == jdm[name], name
    assert port.optimizers.keys() == jax_cfg.optimizers.keys()
    for group, spec in port.optimizers.items():
        jspec = jax_cfg.optimizers[group]
        _same_config(spec["optimizer"], jspec["optimizer"], f"{group}.optimizer")
        if spec["scheduler"] is None:
            assert jspec["scheduler"] is None
        else:
            assert type(spec["scheduler"]).__name__ == type(jspec["scheduler"]).__name__
            assert _fields(spec["scheduler"]) == _fields(jspec["scheduler"])


def test_trainer_configs_reference_the_tables():
    assert set(mc.trainer_configs) == set(mc.model_configs) == set(mc.model_names)
    for method, cfg in mc.trainer_configs.items():
        assert cfg.pipeline.model is mc.model_configs[method]
        assert cfg.optimizers is mc.optimizer_configs[method]
        assert (cfg.pipeline.datamanager.train_num_rays_per_batch
                == mc.train_num_rays_per_batch[method])


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((REPO / "soccernerfs_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 50
    # the entry points and their modules are among them
    port = REPO / "soccernerfs_tpu_torch"
    assert {port / name for name in (
        "configs/cli.py", "scripts/train.py", "scripts/eval.py",
        "scripts/render.py", "utils/eval_utils.py", "utils/dynmetric.py",
        "utils/colormaps.py", "utils/profiler.py", "core/camera_paths.py",
        "viewer/server.py", "data/colmap_utils.py",
        "data/dataparsers/instant_ngp_data.py", "data/dataparsers/minimal.py",
        "data/dataparsers/misc_parsers.py", "scripts/process_data.py",
        "scripts/capture_converters.py", "scripts/sfm_tools.py",
        "scripts/figures.py", "utils/figures.py", "plugins.py",
        "scripts/completions.py")} <= set(files)
    bad = [(str(f.relative_to(REPO)), name) for f in files for name in _imports(f)
           if name.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax",
                                     "soccernerfs_tpu")]
    assert not bad, bad


@pytest.mark.slow
def test_kplanes_static_converges(tmp_path):
    """tests/test_convergence.py on the port: k-planes-static on the
    blender fixture, 300 steps, held-out PSNR > 20.5 and SSIM > 0.44."""
    data = make_blender_fixture(tmp_path / "data")
    cfg = copy.deepcopy(mc.trainer_configs["k-planes-static"])
    cfg.pipeline.model = dataclasses.replace(
        cfg.pipeline.model, spacetime_resolution=(16, 16, 16),
        multiscale_res=(1, 2), feature_dim=8,
        num_proposal_samples_per_ray=(24, 16), num_nerf_samples_per_ray=16,
        sigma_net_hidden_dim=32, rgb_net_hidden_dim=32)
    cfg.pipeline.datamanager.train_num_rays_per_batch = 512
    cfg.pipeline.datamanager.dataparser = BlenderDataParserConfig(data=data)
    cfg.max_num_iterations = 300
    cfg.steps_per_save = 300
    cfg.output_dir = tmp_path / "outputs"
    cfg.vis = "none"
    trainer = Trainer(cfg, device="cpu").setup()
    trainer.train()
    results = average_eval_image_metrics(trainer)
    print(f"k-planes-static after 300 steps: {results}")
    assert results["psnr"] > 20.5, results
    assert results["ssim"] > 0.44, results
