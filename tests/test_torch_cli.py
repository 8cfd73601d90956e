"""The port's ``snt-train`` command line (``configs/cli.py``) against the JAX
package's: every argv of tests/test_cli.py and of
tests/test_eval_render_e2e.py gives the same field values through both
parsers; the refusals (unknown method or flag, a flag without a value);
``--help``'s registry; ``--load-config``; the last two methods ported,
semantic-nerfw and neus, trained through ``snt-train`` and reloaded.
"""
import copy
import dataclasses

import pytest
import torch

from soccernerfs_tpu_torch.data.fixtures import (
    make_nerfstudio_fixture,
    make_sitcoms3d_fixture,
)
from soccernerfs_tpu_torch.scripts import train as train_script
from soccernerfs_tpu_torch.utils.eval_utils import eval_setup
from soccernerfs_tpu_torch.utils.tree import tree_leaves

from soccernerfs_tpu.configs.cli import parse_train_cli as jax_parse
from soccernerfs_tpu.configs.method_configs import descriptions as jax_descriptions
from soccernerfs_tpu.configs.method_configs import method_configs as jax_registry
from soccernerfs_tpu_torch.configs import method_configs as mc
from soccernerfs_tpu_torch.configs.cli import parse_train_cli


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch CPU thread while this file runs (the suite runs in
    parallel worker processes, whose default thread pools oversubscribe
    the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _fields(x):
    return {f.name: getattr(x, f.name) for f in dataclasses.fields(x)}


def _assert_same_config(port, jax_cfg):
    """Every field the port's TrainerConfig has equals the JAX one's: the
    trainer's own, the datamanager's, its dataparser's (type and fields)
    and the model's."""
    for name, value in _fields(port).items():
        if name not in ("machine", "logging", "viewer", "pipeline", "optimizers"):
            assert value == getattr(jax_cfg, name), name
    pdm, jdm = port.pipeline.datamanager, jax_cfg.pipeline.datamanager
    assert type(pdm).__name__ == type(jdm).__name__
    for name, value in _fields(pdm).items():
        if name == "dataparser":
            jdp = jdm.dataparser
            assert type(value).__name__ == type(jdp).__name__
            assert _fields(value) == _fields(jdp)
        elif name == "camera_optimizer":
            assert _fields(value) == _fields(jdm.camera_optimizer)
        else:
            assert value == getattr(jdm, name), name
    jm = _fields(jax_cfg.pipeline.model)
    for name, value in _fields(port.pipeline.model).items():
        if dataclasses.is_dataclass(value):  # neus's SDF field config
            assert _fields(value) == _fields(jm[name]), name
        else:
            assert value == jm[name], name


E2E_ARGV = [
    "k-planes-static",
    "--max-num-iterations", "2",
    "--steps-per-save", "2",
    "--output-dir", "/tmp/out",
    "--pipeline.model.spacetime-resolution", "8", "8", "8",
    "--pipeline.model.multiscale-res", "1", "2",
    "--pipeline.model.feature-dim", "4",
    "--pipeline.model.num-proposal-samples-per-ray", "8", "6",
    "--pipeline.model.num-nerf-samples-per-ray", "4",
    "--pipeline.model.sigma-net-hidden-dim", "16",
    "--pipeline.model.rgb-net-hidden-dim", "16",
    "--pipeline.datamanager.train-num-rays-per-batch", "64",
    "blender-data", "--data", "/tmp/data",
]

# (argv, the values its flags set): tests/test_cli.py's cases and the e2e run
CASES = {
    "method_and_nested_flags": (
        ["k-planes", "--max-num-iterations", "123",
         "--pipeline.model.multiscale-res", "1", "2", "4",
         "--pipeline.datamanager.ist-range", "0.75",
         "broadcaststyle-data", "--fps-downsample", "4", "--data", "/tmp/x"],
        {"max_num_iterations": 123, "pipeline.model.multiscale_res": (1, 2, 4),
         "pipeline.datamanager.ist_range": 0.75,
         "pipeline.datamanager.dataparser.fps_downsample": 4.0}),
    "data_alias_before_dataparser": (
        ["k-planes", "--data", "/tmp/y", "stadium-data"], {}),
    "loss_coefficient_dict_key": (
        ["k-planes", "--pipeline.model.loss-coefficients.space-tv-loss", "0.2"],
        {"pipeline.model.loss_coef": {"space_tv_loss": 0.2}}),
    "frozen_model_config_replace": (
        ["nerfacto", "--pipeline.model.num-nerf-samples-per-ray", "12"],
        {"pipeline.model.num_nerf_samples_per_ray": 12}),
    # depth-nerfacto on a nerfstudio scene, its live viewer on a free port
    "depth_nerfacto_nerfstudio": (
        ["depth-nerfacto", "--max-num-iterations", "16",
         "--viewer.websocket-port", "0",
         "--pipeline.model.depth-loss-type", "urf",
         "--pipeline.model.depth-sigma", "0.02",
         "nerfstudio-data", "--downscale-factor", "2",
         "--depth-unit-scale-factor", "0.001", "--data", "/tmp/ns"],
        {"max_num_iterations": 16, "viewer.websocket_port": 0,
         "pipeline.model.depth_loss_type": "urf",
         "pipeline.model.depth_sigma": 0.02,
         "pipeline.datamanager.dataparser.downscale_factor": 2,
         "pipeline.datamanager.dataparser.depth_unit_scale_factor": 0.001,
         "vis": "viewer"}),
    # experiments/depth_loss_coeff.py's sweep of k-planes' depth weight
    "depth_loss_coeff_sweep": (
        ["k-planes", "--pipeline.model.loss-coefficients.depth-loss", "0.5",
         "broadcaststyle-data", "--depth-maps", "depth-maps", "--data",
         "/tmp/bstyle"],
        {"pipeline.model.loss_coef": {"depth_loss": 0.5, "space_tv_loss": 0.02},
         "pipeline.datamanager.dataparser.depth_maps": "depth-maps"}),
    # experiments/hypernerf_kplanes.py's unbounded k-planes on HyperNeRF data
    "hypernerf_kplanes_unbounded": (
        ["k-planes", "--pipeline.model.bounded", "false", "hypernerf-data",
         "--downscale-factor", "2", "--data", "/tmp/hn"],
        {"pipeline.model.bounded": False,
         "pipeline.datamanager.dataparser.downscale_factor": 2}),
    # TensoRF with its upsampling steps compressed
    "tensorf_upsampling_iters": (
        ["tensorf", "--max-num-iterations", "48",
         "--pipeline.model.upsampling-iters", "8", "16", "24", "32", "40",
         "blender-data", "--data", "/tmp/blender"],
        {"max_num_iterations": 48,
         "pipeline.model.upsampling_iters": (8, 16, 24, 32, 40),
         "mixed_precision": False}),
    "dnerf_on_dnerf_data": (
        ["dnerf", "--max-num-iterations", "8", "dnerf-data", "--data",
         "/tmp/dnerf"],
        {"max_num_iterations": 8, "pipeline.model_name": "vanilla_nerf"}),
    "mipnerf_nerfstudio": (
        ["mipnerf", "--pipeline.model.num-importance-samples", "64",
         "nerfstudio-data", "--data", "/tmp/ns"],
        {"pipeline.model.num_importance_samples": 64,
         "pipeline.datamanager.train_num_rays_per_batch": 1024}),
    # semantic-nerfw on Sitcoms3D, a narrower semantic head's classes
    "semantic_nerfw_sitcoms3d": (
        ["semantic-nerfw", "--pipeline.model.num-semantic-classes", "12",
         "sitcoms3d-data", "--downscale-factor", "2", "--data", "/tmp/sc"],
        {"pipeline.model.num_semantic_classes": 12,
         "pipeline.datamanager.dataparser.downscale_factor": 2,
         "pipeline.datamanager.dataparser.include_semantics": True,
         "pipeline.model_name": "semantic_nerfw"}),
    # neus on a nerfstudio scene, its SDF field's width through the nested
    # frozen config
    "neus_nerfstudio": (
        ["neus", "--pipeline.model.sdf-field.hidden-dim", "64",
         "--pipeline.model.far-plane", "6.0", "nerfstudio-data", "--data",
         "/tmp/ns"],
        {"pipeline.model.sdf_field.hidden_dim": 64,
         "pipeline.model.far_plane": 6.0, "mixed_precision": False,
         "pipeline.datamanager.train_num_rays_per_batch": 1024}),
    "eval_render_e2e": (
        E2E_ARGV,
        {"max_num_iterations": 2, "steps_per_save": 2,
         "pipeline.model.spacetime_resolution": (8, 8, 8),
         "pipeline.model.feature_dim": 4,
         "pipeline.model.num_proposal_samples_per_ray": (8, 6),
         "pipeline.datamanager.train_num_rays_per_batch": 64}),
}


def _get(obj, dotted):
    for part in dotted.split("."):
        obj = getattr(obj, part)
    return obj


@pytest.mark.parametrize("case", sorted(CASES))
def test_cli_matches_jax(case):
    argv, values = CASES[case]
    port, jax_cfg = parse_train_cli(list(argv)), jax_parse(list(argv))
    _assert_same_config(port, jax_cfg)
    for dotted, value in values.items():
        if dotted == "pipeline.model.loss_coef":
            coef = _get(port, dotted)
            assert {k: coef[k] for k in value} == value
        else:
            assert _get(port, dotted) == value, dotted
    if "--data" in argv:
        data = argv[argv.index("--data") + 1]
        assert str(port.pipeline.datamanager.dataparser.data) == data
    # the registry's entry is a copy, untouched
    assert _fields(mc.trainer_configs[argv[0]].pipeline.model) == _fields(
        mc.model_configs[argv[0]])


@pytest.mark.parametrize("argv, message", [
    (["not-a-method"], "unknown method"),
    (["k-planes", "--no.such.flag", "1"], "unknown option"),
    (["k-planes", "--pipeline.model.loss-coefficients.no-such-loss", "1"],
     "unknown key"),
    (["k-planes", "--max-num-iterations"], "needs a value"),
    (["k-planes", "stray"], "unexpected token"),
])
def test_cli_exits(argv, message):
    with pytest.raises(SystemExit, match=message):
        parse_train_cli(argv)


# the last two methods the port took on: each trains a few steps through
# snt-train at narrow widths, and eval_setup reloads the run
TRAINS = {
    "semantic-nerfw": (
        ["--pipeline.model.num-levels", "3", "--pipeline.model.max-res", "64",
         "--pipeline.model.log2-hashmap-size", "12",
         "--pipeline.model.hidden-dim", "16",
         "--pipeline.model.hidden-dim-color", "16",
         "--pipeline.model.num-proposal-samples-per-ray", "12", "8",
         "--pipeline.model.num-nerf-samples-per-ray", "6",
         "--pipeline.model.num-semantic-classes", "3",
         "--pipeline.model.eval-num-rays-per-chunk", "256",
         "--pipeline.datamanager.train-num-rays-per-batch", "128",
         "--pipeline.datamanager.eval-num-rays-per-batch", "128",
         "sitcoms3d-data"],
        lambda root: make_sitcoms3d_fixture(root, num_cameras=3, h=12, w=16)),
    "neus": (
        ["--pipeline.model.sdf-field.num-layers", "3",
         "--pipeline.model.sdf-field.hidden-dim", "32",
         "--pipeline.model.sdf-field.geo-feat-dim", "16",
         "--pipeline.model.sdf-field.num-layers-color", "2",
         "--pipeline.model.sdf-field.hidden-dim-color", "16",
         "--pipeline.model.num-samples", "16",
         "--pipeline.model.num-samples-importance", "16",
         "--pipeline.model.near-plane", "1.0", "--pipeline.model.far-plane", "4.0",
         "--pipeline.model.eval-num-rays-per-chunk", "256",
         "--pipeline.datamanager.train-num-rays-per-batch", "128",
         "nerfstudio-data"],
        lambda root: make_nerfstudio_fixture(root, num_frames=10, h=12, w=16)),
}


@pytest.mark.parametrize("method", sorted(TRAINS))
def test_cli_trains_and_reloads(method, tmp_path, monkeypatch):
    """Three steps through snt-train on the CPU (a finite loss at every
    logged step, a checkpoint at the end); eval_setup reloads the run with
    the trainer's params bit for bit."""
    from soccernerfs_tpu_torch.utils import writer

    flags, fixture = TRAINS[method]
    data = fixture(tmp_path / "data")
    seen = []

    class Sink(writer.Writer):
        def write_scalar(self, name, scalar, step):
            seen.append((name, step, scalar))

    sink = Sink()
    setup_writers = writer.setup_writers

    def with_sink(*args, **kwargs):
        setup_writers(*args, **kwargs)
        writer._SINKS.append(sink)

    monkeypatch.setattr(writer, "setup_writers", with_sink)
    trainer = train_script.main(
        [method, "--max-num-iterations", "3", "--steps-per-save", "3",
         "--vis", "none", "--logging.steps-per-log", "1",
         "--output-dir", str(tmp_path / "out"), *flags, "--data", str(data)],
        device="cpu")
    writer._SINKS.remove(sink)
    losses = [v for n, _s, v in seen if n == "Train Loss"]
    assert len(losses) == 3 and all(torch.isfinite(torch.tensor(losses)))
    if method == "semantic-nerfw":
        assert [n for n, _s, _v in seen if n.endswith("/semantics_loss")]
    else:
        assert [n for n, _s, _v in seen if n.endswith("/eikonal_loss")]
    config, loaded, step = eval_setup(trainer.base_dir / "config.yml", device="cpu")
    assert config.method_name == method and step == 3
    for a, b in zip(tree_leaves(loaded.state.params), tree_leaves(trainer.state.params)):
        assert torch.equal(a, b)


def test_cli_registry_and_help(capsys):
    """The port's methods are the JAX registry; the descriptions are JAX's;
    --help lists them and exits 0."""
    assert set(mc.descriptions) == set(mc.trainer_configs)
    assert set(mc.trainer_configs) == set(jax_registry)
    assert mc.descriptions == {k: jax_descriptions[k] for k in mc.descriptions}
    for argv in (["--help"], ["k-planes", "--help"]):
        with pytest.raises(SystemExit) as exit_info:
            parse_train_cli(argv)
        assert exit_info.value.code == 0
    out = capsys.readouterr().out
    assert all(mc.descriptions[k] in out for k in mc.descriptions)
    assert "vanilla-nerf" in out and "broadcaststyle-data" in out


def test_cli_load_config_replaces_the_config(tmp_path):
    cfg = copy.deepcopy(mc.trainer_configs["k-planes"])
    cfg.output_dir, cfg.timestamp, cfg.max_num_iterations = tmp_path, "t", 77
    saved = cfg.save_config()
    loaded = parse_train_cli(["k-planes", "--load-config", str(saved)])
    assert loaded.max_num_iterations == 77
    assert _fields(loaded.pipeline.model) == _fields(cfg.pipeline.model)
