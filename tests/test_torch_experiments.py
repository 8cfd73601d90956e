"""The port's repository-level tools against the JAX package's: the sweep
harness and its 21 drivers (``soccernerfs_tpu_torch.experiments``), and
the dataset tools ``compute_ist``, ``mask_depth_maps`` and ``plot_kplane``
(``soccernerfs_tpu_torch.scripts``).

The JAX side runs the repository's own files (``experiments/*.py``,
``scripts/*.py``) unedited, through ``runpy`` in this process (the
conftest keeps JAX on the CPU); the port's tools run on the CPU by
``--device cpu``.  A sweep's commands are recorded at ``Experiment._sh``
on both sides instead of run.
"""
import json
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from soccernerfs_tpu_torch import convert
from soccernerfs_tpu_torch.configs.cli import parse_train_cli
from soccernerfs_tpu_torch.data.fixtures import (
    make_blender_fixture,
    make_broadcaststyle_fixture,
)
from soccernerfs_tpu_torch.experiments import snt_experiment as texp
from soccernerfs_tpu_torch.experiments import sweeps
from soccernerfs_tpu_torch.scripts import compute_ist as tist
from soccernerfs_tpu_torch.scripts import mask_depth_maps as tmask
from soccernerfs_tpu_torch.scripts import plot_kplane as tplot
from soccernerfs_tpu_torch.scripts import train as train_script

REPO = Path(__file__).resolve().parents[1]
DRIVERS = sorted(p.stem for p in (REPO / "experiments").glob("*.py")
                 if p.stem != "snt_experiment")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch CPU thread while this file runs (the suite runs in
    parallel worker processes, whose default thread pools oversubscribe
    the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# the sweep harness and its drivers
# ---------------------------------------------------------------------------

def _recording(monkeypatch, module, root):
    """Record the commands of ``module``'s Experiment instead of running
    them, with its outputs under ``root``."""
    cmds = []
    monkeypatch.setattr(module, "OUTPUT_ROOT", root)
    monkeypatch.setattr(module.Experiment, "_sh", lambda self, cmd: cmds.append(cmd))
    return cmds


def _jax_driver(monkeypatch, name, root):
    """The JAX driver ``experiments/<name>.py`` run as a script; its
    commands."""
    monkeypatch.syspath_prepend(str(REPO / "experiments"))
    import snt_experiment as jexp   # the JAX harness, beside its drivers

    cmds = _recording(monkeypatch, jexp, root)
    monkeypatch.setattr(sys, "argv", [f"{name}.py"])
    runpy.run_path(str(REPO / "experiments" / f"{name}.py"), run_name="__main__")
    return cmds


def test_there_are_21_drivers_and_each_has_a_module():
    assert len(DRIVERS) == 21
    assert sorted(sweeps.DRIVERS) == DRIVERS
    port = REPO / "soccernerfs_tpu_torch" / "experiments"
    assert all((port / f"{name}.py").is_file() for name in DRIVERS)


@pytest.mark.parametrize("name", DRIVERS)
def test_driver_builds_the_jax_commands(monkeypatch, tmp_path, name):
    """``python -m soccernerfs_tpu_torch.experiments.<name>`` builds the JAX
    driver's argv, command for command, with the port's entry points in
    place of the JAX package's, and writes the same params.json."""
    want = _jax_driver(monkeypatch, name, tmp_path / "jax")
    got = _recording(monkeypatch, texp, tmp_path / "port")
    monkeypatch.setattr(sys, "argv", [name])
    runpy.run_module(f"soccernerfs_tpu_torch.experiments.{name}", run_name="__main__")
    swap = {"soccernerfs_tpu.scripts.train": "soccernerfs_tpu_torch.scripts.train",
            "soccernerfs_tpu.scripts.render": "soccernerfs_tpu_torch.scripts.render",
            "soccernerfs_tpu.scripts.eval": "soccernerfs_tpu_torch.scripts.eval"}
    want = [[swap.get(a, a).replace(str(tmp_path / "jax"), str(tmp_path / "port"))
             for a in cmd] for cmd in want]
    assert want and got == want
    assert ((tmp_path / "port" / name / "params.json").read_text()
            == (tmp_path / "jax" / name / "params.json").read_text())


def test_driver_arguments_cut_a_sweep_and_reach_the_train_cli(monkeypatch, tmp_path):
    """--runs, --data, --cam-path and the extra arguments of each command
    kind; the train command parses with the port's snt-train grammar
    (kp_res_study's third run: F = 24 at scales 1..32)."""
    cmds = _recording(monkeypatch, texp, tmp_path)
    sweeps.main("kp_res_study", [
        "--runs", "2", "--data", "/scene", "--cam-path", "path.json",
        "--train-args", "--max-num-iterations 32 --vis none",
        "--render-args", "--output-format images", "--eval-args", "--foo 1"])
    train, render, evaluate = cmds
    slug = "24-64_64_64_100-1_2_4_8_16_32"
    assert train[2:4] == ["soccernerfs_tpu_torch.scripts.train", "k-planes"]
    assert train[-7:] == ["--max-num-iterations", "32", "--vis", "none",
                          "stadium-data", "--data", "/scene"]
    assert render[-4:] == ["--output-path", str(tmp_path / "kp_res_study" / "renders"
                                                / f"{slug}.mp4"),
                           "--output-format", "images"]
    assert render[render.index("--camera-path-filename") + 1] == "path.json"
    assert evaluate[-2:] == ["--foo", "1"]
    config = parse_train_cli(train[3:])
    model = config.pipeline.model
    assert (model.feature_dim, tuple(model.multiscale_res)) == (24, (1, 2, 4, 8, 16, 32))
    assert tuple(model.spacetime_resolution) == (64, 64, 64, 100)
    assert config.max_num_iterations == 32
    assert str(config.pipeline.datamanager.dataparser.data) == "/scene"
    assert config.experiment_name == "kp_res_study" and config.timestamp == slug
    with pytest.raises(ValueError):
        texp.Experiment("x", None, "k-planes", extra_args={"viewer": ["--a"]})


# ---------------------------------------------------------------------------
# compute_ist
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("isg", [False, True])
def test_compute_ist_writes_the_jax_caches(monkeypatch, tmp_path, isg):
    """IST (range 0.5) or ISG on one broadcaststyle fixture written twice:
    the same cache file name, weights within 1e-6, the same previews."""
    roots = {}
    for side in ("jax", "port"):
        roots[side] = make_broadcaststyle_fixture(tmp_path / side, num_cameras=3,
                                                  num_steps=5, h=24, w=32)
    args = ["--dataparser", "broadcaststyle-data", "--save-maps",
            *(["--isg"] if isg else ["--ist-range", "0.5"])]
    monkeypatch.setattr(sys, "argv", ["compute_ist.py", "--data",
                                      str(roots["jax"]), *args])
    runpy.run_path(str(REPO / "scripts" / "compute_ist.py"), run_name="__main__")
    weights = tist.main(["--data", str(roots["port"]), *args, "--device", "cpu"])

    kind = "isg" if isg else "ist"
    caches = {side: sorted((root / "images" / "2x").glob(f"{kind}-weights-*.npy"))
              for side, root in roots.items()}
    assert [p.name for p in caches["port"]] == [p.name for p in caches["jax"]]
    assert len(caches["port"]) == 1
    want = np.load(caches["jax"][0])
    got = np.load(caches["port"][0])
    assert got.dtype == want.dtype == np.float16 and got.shape == want.shape
    np.testing.assert_allclose(got.astype(np.float32), want.astype(np.float32),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(weights, got)
    maps = {side: sorted((root / "images" / f"{kind}_maps_offline").iterdir())
            for side, root in roots.items()}
    assert [p.name for p in maps["port"]] == [p.name for p in maps["jax"]]
    for p, q in zip(maps["port"], maps["jax"]):
        np.testing.assert_array_equal(np.asarray(Image.open(p)),
                                      np.asarray(Image.open(q)))


# ---------------------------------------------------------------------------
# mask_depth_maps
# ---------------------------------------------------------------------------

@pytest.fixture
def no_detector(monkeypatch):
    """No RetinaNet on the JAX side either (its detector would fetch
    weights): detections come from the sidecar boxes only."""
    from soccernerfs_tpu.utils import dynmetric as jdyn

    monkeypatch.setattr(jdyn, "_detect_torchvision", lambda image: None)


@pytest.mark.parametrize("boxes", [False, True])
@pytest.mark.parametrize("mode", ["od", "od_below"])
def test_mask_depth_maps_matches_jax(monkeypatch, tmp_path, no_detector, mode,
                                     boxes):
    """Depth PNGs masked around sidecar boxes (SNT_DYNMETRIC_BOXES; a box
    on some images, none on one, an image without an entry), or copied
    through without boxes: the same files, byte for byte."""
    data = make_broadcaststyle_fixture(tmp_path / "data", num_cameras=2,
                                       num_steps=3, h=24, w=32, with_depth=True)
    images, depths = data / "images" / "2x", data / "depth-maps-mask" / "2x"
    names = sorted(p.name for p in images.iterdir())
    if boxes:
        table = {names[0]: [{"box": [3.5, 2.0, 11.2, 9.9], "label": 1}],
                 names[1]: [{"box": [0, 0, 5, 4]}, {"box": [20, 10, 40, 30]}],
                 names[2]: []}
        sidecar = tmp_path / "boxes.json"
        sidecar.write_text(json.dumps(table))
        monkeypatch.setenv("SNT_DYNMETRIC_BOXES", str(sidecar))
    else:
        monkeypatch.delenv("SNT_DYNMETRIC_BOXES", raising=False)
    common = ["--images", str(images), "--depths", str(depths), "--mode", mode]
    monkeypatch.setattr(sys, "argv", ["mask_depth_maps.py", *common, "--out",
                                      str(tmp_path / "jax")])
    runpy.run_path(str(REPO / "scripts" / "mask_depth_maps.py"), run_name="__main__")
    tmask.main([*common, "--out", str(tmp_path / "port"), "--device", "cpu"])
    got = sorted((tmp_path / "port").iterdir())
    assert [p.name for p in got] == names
    masked = 0
    for p in got:
        assert p.read_bytes() == (tmp_path / "jax" / p.name).read_bytes()
        depth = np.asarray(Image.open(p))
        masked += int((depth == 0).sum())
        if not boxes:
            np.testing.assert_array_equal(depth, np.asarray(Image.open(depths / p.name)))
    assert (masked > 0) == boxes


# ---------------------------------------------------------------------------
# plot_kplane
# ---------------------------------------------------------------------------

class _Snapshot:
    """What plot_kplane reads of eval_setup's trainer: state.params."""

    def __init__(self, params):
        self.state = type("State", (), {"params": params})()


def test_plot_kplane_writes_the_jax_pngs(monkeypatch, tmp_path):
    """One parameter tree (two scales of 4D planes and a static scale, F =
    6), as JAX's eval_setup and as the port's would give it (the port's
    through convert.params_from_jax): the same PNG files, byte for byte."""
    from soccernerfs_tpu.utils import eval_utils as jeval
    from soccernerfs_tpu_torch.utils import eval_utils as teval

    rng = np.random.default_rng(0)
    shapes = [[(5, 7), (6, 7), (4, 7), (6, 5), (4, 5), (4, 6)],
              [(10, 14), (12, 14), (4, 14), (12, 10), (4, 10), (4, 12)],
              [(5, 7), (6, 7), (6, 5)]]
    tree = {"fields": {"grids": [[rng.uniform(0.1, 0.5, (*s, 6)).astype(np.float32)
                                  for s in scale] for scale in shapes]}}
    monkeypatch.setattr(jeval, "eval_setup",
                        lambda path, mode: (None, _Snapshot(tree), 7))
    monkeypatch.setattr(teval, "eval_setup", lambda path, mode, device=None: (
        None, _Snapshot(convert.params_from_jax(tree, device="cpu")), 7))
    monkeypatch.setattr(sys, "argv", ["plot_kplane.py", "--load-config", "x.yml",
                                      "--out", str(tmp_path / "jax")])
    runpy.run_path(str(REPO / "scripts" / "plot_kplane.py"), run_name="__main__")
    tplot.main(["--load-config", "x.yml", "--out", str(tmp_path / "port"),
                "--device", "cpu"])
    got = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert got == sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert len(got) == 15 and "scale2_YZ.png" in got and "scale1_ZT.png" in got
    for name in got:
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes())


def test_plot_kplane_on_a_trained_snapshot(tmp_path):
    """The port's tool through its own eval_setup on a 2-step
    k-planes-static run (F = 4, padded to 8 by the kernels' wrappers):
    one PNG per plane and scale, the planes' own sizes."""
    data = make_blender_fixture(tmp_path / "data")
    trainer = train_script.main(
        ["k-planes-static", "--max-num-iterations", "2", "--steps-per-save", "2",
         "--pipeline.model.spacetime-resolution", "8", "8", "8",
         "--pipeline.model.multiscale-res", "1", "2",
         "--pipeline.model.feature-dim", "4",
         "--pipeline.model.num-proposal-samples-per-ray", "8", "6",
         "--pipeline.model.num-nerf-samples-per-ray", "4",
         "--pipeline.model.sigma-net-hidden-dim", "16",
         "--pipeline.model.rgb-net-hidden-dim", "16",
         "--pipeline.datamanager.train-num-rays-per-batch", "64",
         "--pipeline.datamanager.eval-num-rays-per-batch", "64",
         "--vis", "none", "--output-dir", str(tmp_path / "out"),
         "blender-data", "--data", str(data)], device="cpu")
    out = tplot.main(["--load-config", str(trainer.base_dir / "config.yml"),
                      "--out", str(tmp_path / "planes"), "--device", "cpu"])
    grids = trainer.state.params["fields"]["grids"]
    for s, planes in enumerate(grids):
        for plane, name in zip(planes, tplot.PLANE_NAMES_3D):
            img = Image.open(out / f"scale{s}_{name}.png")
            assert img.size == (plane.shape[1], plane.shape[0])
    assert len(list(out.iterdir())) == 6
