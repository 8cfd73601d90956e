"""The port's host tooling against the JAX package's: figures (frustum
geometry, ``vis_dataset``, turbo, split, crop and the ``snt-figures``
CLI), shell completions, method plugins, and the coverage of the JAX
package's modules by the port's.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from soccernerfs_tpu.core.cameras import Cameras as JCameras
from soccernerfs_tpu.scripts import completions as jcomp
from soccernerfs_tpu.scripts import figures as jfigcli
from soccernerfs_tpu.utils import figures as jfig
from soccernerfs_tpu_torch.core.cameras import Cameras as TCameras
from soccernerfs_tpu_torch.scripts import completions as tcomp
from soccernerfs_tpu_torch.scripts import figures as tfigcli
from soccernerfs_tpu_torch.utils import figures as tfig

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch CPU thread while this file runs (the suite runs in
    parallel worker processes, whose default thread pools oversubscribe
    the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _camera_args(n=4):
    rng = np.random.default_rng(0)
    c2w = np.zeros((n, 3, 4), np.float32)
    for i in range(n):
        th = 2 * np.pi * i / n + rng.uniform(-0.1, 0.1)
        z = np.array([np.cos(th), np.sin(th), 0.4])
        z /= np.linalg.norm(z)
        x = np.cross([0.0, 0.0, 1.0], z)
        x /= np.linalg.norm(x)
        c2w[i, :, 0], c2w[i, :, 1], c2w[i, :, 2] = x, np.cross(z, x), z
        c2w[i, :, 3] = z * 3.0
    return dict(camera_to_worlds=c2w, fx=rng.uniform(90, 110, n),
                fy=rng.uniform(90, 110, n), cx=32.0, cy=24.0, width=64,
                height=48)


# ---------------------------------------------------------------------------
# figures
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("depth", [0.3, 0.5])
def test_frustums_match_jax(depth):
    args = _camera_args()
    t = tfig.camera_frustum_segments(TCameras.create(**args, device="cpu"), depth)
    j = jfig.camera_frustum_segments(JCameras.create(**args), depth)
    assert t.shape == (32, 2, 3)
    np.testing.assert_array_equal(t, j)
    c2w = args["camera_to_worlds"][1]
    corners = tfig.frustum_corners(c2w, 100.0, 101.0, 30.0, 20.0, 64, 48, depth)
    np.testing.assert_array_equal(
        corners, jfig.frustum_corners(c2w, 100.0, 101.0, 30.0, 20.0, 64, 48, depth))
    np.testing.assert_array_equal(tfig.frustum_segments(corners),
                                  jfig.frustum_segments(corners))


def test_vis_dataset_matches_jax(tmp_path):
    """The same figure from the port's cameras and rays (tensors) as from
    JAX's (arrays)."""
    args = _camera_args()
    rng = np.random.default_rng(1)
    o = rng.normal(size=(20, 3)).astype(np.float32)
    d = rng.normal(size=(20, 3)).astype(np.float32)
    t = tfig.vis_dataset(TCameras.create(**args, device="cpu"),
                         torch.from_numpy(o), torch.from_numpy(d), max_rays=12,
                         save_path=str(tmp_path / "t.png"))
    j = jfig.vis_dataset(JCameras.create(**args), o, d, max_rays=12,
                         save_path=str(tmp_path / "j.png"))
    assert (t, j) == (str(tmp_path / "t.png"), str(tmp_path / "j.png"))
    a, b = (np.asarray(Image.open(p)) for p in (t, j))
    assert a.shape == b.shape and a.size > 1000
    np.testing.assert_array_equal(a, b)


def test_turbo_split_crop_match_jax():
    rng = np.random.default_rng(2)
    for g in (rng.uniform(-0.2, 1.2, (16, 24)), rng.uniform(0, 1, (8, 8, 1))):
        np.testing.assert_array_equal(tfig.turbo_colormap(g), jfig.turbo_colormap(g))
    strip = rng.integers(0, 255, (6, 30, 3), dtype=np.uint8)
    for a, b in zip(tfig.split_strip(strip, 3), jfig.split_strip(strip, 3)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(AssertionError):
        tfig.split_strip(strip, 4)
    gt = rng.integers(0, 255, (20, 20, 3), dtype=np.uint8)
    preds = [rng.integers(0, 255, (20, 20, 3), dtype=np.uint8) for _ in range(2)]
    t = tfig.crop_panels(gt, preds, (3, 4, 9, 7), border=2, color=(0, 255, 0))
    j = jfig.crop_panels(gt, preds, (3, 4, 9, 7), border=2, color=(0, 255, 0))
    np.testing.assert_array_equal(t[0], j[0])
    for a, b in zip(t[1], j[1]):
        np.testing.assert_array_equal(a, b)


def _tree(root: Path) -> dict:
    return {p.relative_to(root).as_posix(): np.asarray(Image.open(p)).tobytes()
            for p in sorted(root.rglob("*.png"))}


@pytest.mark.parametrize("cmd", ["crop", "split", "turbo"])
def test_figures_cli_matches_jax(tmp_path, cmd, capsys):
    rng = np.random.default_rng(3)
    for name in ("gt", "p1", "p2"):
        Image.fromarray(rng.integers(0, 255, (16, 24, 3), dtype=np.uint8)).save(
            tmp_path / f"{name}.png")
    images = [str(tmp_path / f"{n}.png") for n in ("gt", "p1", "p2")]
    argv = {"crop": ["--gt", images[0], "--preds", *images[1:], "--rect", "2",
                     "3", "8", "6"],
            "split": ["--images", *images, "--panels", "3"],
            "turbo": ["--images", *images]}[cmd]
    outs = []
    for name, main in (("jax", jfigcli.main), ("port", tfigcli.main)):
        assert main([cmd, *argv, "-o", str(tmp_path / name)]) == 0
        outs.append(capsys.readouterr().out.replace(str(tmp_path / name), "OUT"))
    assert outs[0] == outs[1]
    j, t = _tree(tmp_path / "jax"), _tree(tmp_path / "port")
    assert t == j and len(t) >= 3


def test_figures_help_matches_jax(capsys):
    texts = []
    for main in (jfigcli.main, tfigcli.main):
        for argv in (["--help"], ["cropvid", "--help"], ["crop", "--help"]):
            with pytest.raises(SystemExit):
                main(argv)
        texts.append(capsys.readouterr().out)
    # the descriptions are each module's docstring; the arguments agree
    strip = [t.split("positional arguments:")[-1] for t in texts]
    assert strip[0] == strip[1] and "{crop,split,turbo,cropvid}" in strip[1]


# ---------------------------------------------------------------------------
# completions
# ---------------------------------------------------------------------------

def test_completion_scripts_match_jax():
    """The bash and zsh text of JAX's, the package's name in the markers
    aside; every method and dataparser of the port's registry in them."""
    for gen in ("generate_bash", "generate_zsh"):
        t, j = getattr(tcomp, gen)(), getattr(jcomp, gen)()
        assert t.replace("soccernerfs_tpu_torch", "soccernerfs_tpu") == j
        assert "# >>> soccernerfs_tpu_torch completions >>>" in t
    from soccernerfs_tpu_torch.configs.method_configs import trainer_configs
    from soccernerfs_tpu_torch.data.dataparsers import DATAPARSERS

    words = tcomp.generate_bash().split('compgen -W "')[1].split('"')[0].split()
    assert words == sorted(trainer_configs) + sorted(DATAPARSERS)
    assert tcomp.COMMANDS == jcomp.COMMANDS


def test_completions_install_and_uninstall(tmp_path, monkeypatch):
    """Install into each shell's rc once, beside the JAX package's block;
    uninstall takes out the port's block only."""
    monkeypatch.setenv("HOME", str(tmp_path))
    (tmp_path / ".bashrc").write_text("export A=1\n")
    jcomp.install("bash", tmp_path / "jax")
    for shell in ("bash", "zsh"):
        script = tcomp.install(shell, tmp_path / "port")
        tcomp.install(shell, tmp_path / "port")
        assert script == tmp_path / "port" / f"snt_completions.{shell}"
        rc = tmp_path / (".bashrc" if shell == "bash" else ".zshrc")
        assert rc.read_text().count(f"source {script}") == 1
    assert "autoload -U +X bashcompinit" in (tmp_path / "port" /
                                             "snt_completions.zsh").read_text()
    tcomp.main(["--mode", "uninstall"])
    bashrc = (tmp_path / ".bashrc").read_text()
    assert bashrc.startswith("export A=1\n")
    assert "soccernerfs_tpu_torch" not in bashrc
    assert f"source {tmp_path / 'jax' / 'snt_completions.bash'}" in bashrc
    assert "source" not in (tmp_path / ".zshrc").read_text()
    # the default directory of the main, under the (patched) home
    tcomp.main(["--shells", "bash", "--completions-dir",
                str(tmp_path / "cli")])
    assert (tmp_path / "cli" / "snt_completions.bash").is_file()


# ---------------------------------------------------------------------------
# plugins
# ---------------------------------------------------------------------------

def _plugin(root: Path, body: str, name="dummy_snt_torch_plugin"):
    """An installed distribution on ``root``: a module and its dist-info
    with one entry point of the port's group."""
    (root / f"{name}.py").write_text(textwrap.dedent(body))
    dist = root / f"{name}-0.1.dist-info"
    dist.mkdir()
    (dist / "METADATA").write_text(
        f"Metadata-Version: 2.1\nName: {name.replace('_', '-')}\nVersion: 0.1\n")
    (dist / "entry_points.txt").write_text(
        "[soccernerfs_tpu_torch.method_configs]\n"
        f"dummy-torch-method = {name}:spec\n")
    (dist / "RECORD").write_text("")


PLUGIN = """
    import copy
    from soccernerfs_tpu_torch.models import register_model
    from soccernerfs_tpu_torch.plugins import MethodSpecification
    from soccernerfs_tpu_torch.configs.method_configs import trainer_configs

    register_model("dummy_model", "soccernerfs_tpu_torch.models.nerfacto")
    _cfg = copy.deepcopy(trainer_configs["nerfacto"])
    _cfg.method_name = "dummy-torch-method"
    _cfg.pipeline.model_name = "dummy_model"
    spec = MethodSpecification(config=_cfg, description="a test plugin")
"""


def test_plugin_discovery_from_entry_points(tmp_path, monkeypatch):
    """A package registering the port's group is discovered; the JAX
    package's group does not see it."""
    _plugin(tmp_path, PLUGIN)
    monkeypatch.syspath_prepend(str(tmp_path))
    from soccernerfs_tpu.plugins import discover_methods as jdiscover
    from soccernerfs_tpu_torch.configs.base import TrainerConfig
    from soccernerfs_tpu_torch.plugins import discover_methods

    try:
        methods, descriptions = discover_methods()
        assert list(methods) == ["dummy-torch-method"]
        assert isinstance(methods["dummy-torch-method"], TrainerConfig)
        assert descriptions == {"dummy-torch-method": "a test plugin"}
        assert "dummy-torch-method" not in jdiscover()[0]
    finally:
        sys.modules.pop("dummy_snt_torch_plugin", None)


def test_plugin_joins_the_registry_and_the_cli(tmp_path):
    """In a fresh process with the plugin installed, the registry holds
    it, ``snt-train`` parses it, its model resolves, and the completions
    list it."""
    _plugin(tmp_path, PLUGIN)
    code = textwrap.dedent("""
        from soccernerfs_tpu_torch.configs.cli import parse_train_cli
        from soccernerfs_tpu_torch.configs.method_configs import (
            descriptions, trainer_configs)
        from soccernerfs_tpu_torch.models import get_model
        from soccernerfs_tpu_torch.scripts import completions
        cfg = parse_train_cli(["dummy-torch-method", "--max-num-iterations",
                               "7", "minimal-parser", "--data", "d"])
        assert cfg.method_name == "dummy-torch-method"
        assert cfg.max_num_iterations == 7
        assert type(cfg.pipeline.datamanager.dataparser).__name__ == \\
            "MinimalDataParserConfig"
        assert descriptions["dummy-torch-method"] == "a test plugin"
        assert get_model(cfg.pipeline.model_name).__name__.endswith(".nerfacto")
        assert "dummy-torch-method" in completions.generate_bash()
        assert len(trainer_configs) == 17
        print("ok")
    """)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(tmp_path), str(REPO)])}
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "ok"


def test_broken_plugin_is_reported_not_raised(tmp_path, monkeypatch, capsys):
    _plugin(tmp_path, "spec = 42\n", name="broken_snt_torch_plugin")
    monkeypatch.syspath_prepend(str(tmp_path))
    from soccernerfs_tpu_torch.plugins import discover_methods

    try:
        assert discover_methods() == ({}, {})
        assert "[plugins] method discovery failed" in capsys.readouterr().out
    finally:
        sys.modules.pop("broken_snt_torch_plugin", None)


# ---------------------------------------------------------------------------
# module coverage
# ---------------------------------------------------------------------------

# the JAX package's modules that the port has no counterpart of: the Pallas
# kernels (ported as CUDA kernels under csrc/) and the downloader (it needs
# the network)
UNPORTED = {"ops/pallas/__init__.py", "ops/pallas/plane_kernels.py",
            "scripts/download_data.py"}
RENAMED = {"data/dataparsers/nerfstudio_parser.py": "data/dataparsers/nerfstudio.py"}


def test_every_jax_module_has_a_port_counterpart():
    jax_root, port_root = REPO / "soccernerfs_tpu", REPO / "soccernerfs_tpu_torch"
    jax_mods = {p.relative_to(jax_root).as_posix() for p in jax_root.rglob("*.py")}
    port_mods = {p.relative_to(port_root).as_posix() for p in port_root.rglob("*.py")}
    missing = {m for m in jax_mods if RENAMED.get(m, m) not in port_mods}
    assert missing == UNPORTED
    assert all(m in jax_mods for m in RENAMED)
    assert len(jax_mods) - len(UNPORTED) >= 95


# the repository-level tools that import or run the JAX package, and have
# no counterpart in the port: TPU ablations, microbenchmarks, profilers and
# multi-chip checks (the port's are chip_smoke.py's timed phases)
TPU_TOOLS = {"scripts/ablate_step.py", "scripts/diag_fold.py",
             "scripts/diag_fwd.py", "scripts/diag_temporal.py",
             "scripts/kbench.py", "scripts/kfloor_r4.py", "scripts/kfloor_r5.py",
             "scripts/microbench_pack.py", "scripts/microbench_pairgather.py",
             "scripts/microbench_r3.py", "scripts/profile_method.py",
             "scripts/profile_render.py", "scripts/profile_step.py",
             "scripts/tpu_dynamic_convergence.py", "scripts/validate_spmd_tpu.py"}


def test_every_root_tool_on_the_jax_package_has_a_port_counterpart():
    """The root tools that import the JAX package or run its entry points
    (``experiments/snt_experiment.py`` runs ``soccernerfs_tpu.scripts.*``)
    are the TPU tools above and the sweep harness and three dataset tools,
    each with a module of the same name in the port; every sweep driver
    under ``experiments/`` has its port module too."""
    import re

    uses_jax = re.compile(r"\bsoccernerfs_tpu\b(?!_torch)")
    tools = {p.relative_to(REPO).as_posix()
             for folder in ("experiments", "scripts")
             for p in (REPO / folder).glob("*.py")
             if uses_jax.search(p.read_text())}
    assert TPU_TOOLS <= tools
    ported = tools - TPU_TOOLS
    assert ported == {"experiments/snt_experiment.py", "scripts/compute_ist.py",
                      "scripts/mask_depth_maps.py", "scripts/plot_kplane.py"}
    port = REPO / "soccernerfs_tpu_torch"
    assert all((port / m).is_file() for m in ported)
    drivers = {p.name for p in (REPO / "experiments").glob("*.py")}
    assert len(drivers) == 22
    assert all((port / "experiments" / d).is_file() for d in drivers)
