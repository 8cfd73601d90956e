"""The port's ``snt-train`` command line (``configs/cli.py``) against the JAX
package's: every argv of tests/test_cli.py and of
tests/test_eval_render_e2e.py gives the same field values through both
parsers; the refusals (unknown method or flag, a method not ported yet, a
flag without a value); ``--help``'s registry; ``--load-config``.
"""
import copy
import dataclasses

import pytest
import torch

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
    *[([method], "not ported yet") for method in mc.not_ported],
])
def test_cli_exits(argv, message):
    with pytest.raises(SystemExit, match=message):
        parse_train_cli(argv)


def test_cli_registry_and_help(capsys):
    """The port's methods and the ones not ported yet make up the JAX
    registry; the descriptions are JAX's; --help lists them and exits 0."""
    assert set(mc.descriptions) == set(mc.trainer_configs)
    assert set(mc.trainer_configs) | set(mc.not_ported) == set(jax_registry)
    assert not set(mc.trainer_configs) & set(mc.not_ported)
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
