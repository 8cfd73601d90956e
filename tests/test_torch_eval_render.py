"""The port's eval and render entry points against the JAX package's:
DynMetric's sidecar branch (``utils/dynmetric.py``); train -> eval ->
render end to end on the blender fixture at tests/test_eval_render_e2e.py's
narrow flags (``scripts/{train,eval,render}.py``, ``utils/eval_utils.py``);
a config.yml written by the JAX package refused without importing it;
every entry point on CUDA by default.
"""
import copy
import json
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soccernerfs_tpu.configs.method_configs import method_configs as jax_registry
from soccernerfs_tpu.utils import dynmetric as jdyn
from soccernerfs_tpu.utils import metrics as jmetrics
from soccernerfs_tpu_torch.data.fixtures import make_blender_fixture
from soccernerfs_tpu_torch.engine import checkpoints
from soccernerfs_tpu_torch.scripts import eval as eval_script
from soccernerfs_tpu_torch.scripts import render as render_script
from soccernerfs_tpu_torch.scripts import train as train_script
from soccernerfs_tpu_torch.utils import dynmetric
from soccernerfs_tpu_torch.utils import metrics as tmetrics
from soccernerfs_tpu_torch.utils.eval_utils import eval_setup
from soccernerfs_tpu_torch.utils.tree import tree_leaves

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


def _pair(seed, h=120, w=160):
    rng = np.random.default_rng(seed)
    true = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    pred = np.clip(true + rng.normal(0, 0.1, true.shape), 0, 1).astype(np.float32)
    return true, pred


BOXES = {
    # two players (the one nearer the centre is kept) and a ball
    "a.png": [{"box": [70, 50, 82, 74]}, {"box": [5, 5, 15, 30], "label": 1},
              {"box": [120, 90, 126, 96], "label": 37}],
    # one player near the border: the grown box is shifted inside
    "b.png": [{"box": [150, 100, 158, 118]}],
    # a box that grows to fewer rows than SSIM's window: NaN, as in JAX
    "c.png": [{"box": [60, 60, 70, 63], "label": 37}],
    "empty.png": [],
}


@pytest.mark.parametrize("name", ["a.png", "b.png", "c.png", "empty.png",
                                  "missing.png", None])
def test_dynmetric_sidecar_matches_jax(tmp_path, monkeypatch, name):
    """Boxes from SNT_DYNMETRIC_BOXES: dpsnr within 1e-4 dB and dssim
    within 1e-5 of JAX's, the annotated image equal; no boxes (and no
    detector here) gives NaN on both sides."""
    path = tmp_path / "boxes.json"
    path.write_text(json.dumps(BOXES))
    monkeypatch.setenv("SNT_DYNMETRIC_BOXES", str(path))
    monkeypatch.delenv("SNT_LPIPS_WEIGHTS", raising=False)
    true, pred = _pair(0)
    ann, dpsnr, dssim, dlpips = dynmetric.DynMetric(device="cpu")(
        true, pred, image_name=name)
    jann, jpsnr, jssim, jlpips = jdyn.DynMetric()(true, pred, image_name=name)
    np.testing.assert_array_equal(ann, np.asarray(jann))
    for got, want, tol in ((dpsnr, jpsnr, 1e-4), (dssim, jssim, 1e-5)):
        if np.isnan(want):
            assert np.isnan(got)
        else:
            assert abs(got - want) <= tol
    assert np.isnan(dlpips) and np.isnan(jlpips)
    if name in ("a.png", "b.png"):
        assert np.isfinite(dpsnr) and np.isfinite(dssim)
    if name in ("empty.png", "missing.png", None):
        assert np.isnan(dpsnr) and np.isnan(dssim)


def test_dynmetric_rescale_and_small_ssim_match_jax():
    for box in ([10, 10, 20, 30], [150, 100, 158, 118], [0, 0, 100, 100]):
        assert dynmetric.rescale_bbox(box, 7, 2.5, 160, 120) == jdyn.rescale_bbox(
            box, 7, 2.5, 160, 120)
    true, pred = _pair(1, h=8, w=40)
    assert np.isnan(float(tmetrics.ssim(torch.from_numpy(true),
                                        torch.from_numpy(pred))))
    assert np.isnan(float(jmetrics.ssim(jnp.asarray(true), jnp.asarray(pred))))


E2E_FLAGS = [
    "--max-num-iterations", "2",
    "--steps-per-save", "2",
    "--pipeline.model.spacetime-resolution", "8", "8", "8",
    "--pipeline.model.multiscale-res", "1", "2",
    "--pipeline.model.feature-dim", "4",
    "--pipeline.model.num-proposal-samples-per-ray", "8", "6",
    "--pipeline.model.num-nerf-samples-per-ray", "4",
    "--pipeline.model.sigma-net-hidden-dim", "16",
    "--pipeline.model.rgb-net-hidden-dim", "16",
    "--pipeline.datamanager.train-num-rays-per-batch", "64",
]


@pytest.fixture(scope="module")
def trained_run(tmp_path_factory):
    """tests/test_eval_render_e2e.py's run through the port's snt-train."""
    root = tmp_path_factory.mktemp("e2e")
    data = make_blender_fixture(root / "data")
    out = root / "outputs"
    trainer = train_script.main(
        ["k-planes-static", *E2E_FLAGS, "--output-dir", str(out),
         "blender-data", "--data", str(data)], device="cpu")
    runs = sorted(out.glob("*/k-planes-static/*/config.yml"))
    assert runs == [trainer.base_dir / "config.yml"]
    return root, runs[-1]


def test_eval_json_matches_ns_eval_schema(trained_run):
    root, config_path = trained_run
    out_json = root / "results.json"
    info = eval_script.main(["--load-config", str(config_path),
                             "--output-path", str(out_json)], device="cpu")
    payload = json.loads(out_json.read_text())
    assert payload == json.loads(json.dumps(info))
    assert {"experiment_name", "method_name", "checkpoint", "results"} <= set(payload)
    assert payload["method_name"] == "k-planes-static"
    assert payload["checkpoint"] == "2"
    results = payload["results"]
    for key in ("psnr", "ssim", "lpips", "dpsnr", "dssim", "dlpips",
                "num_rays_per_sec", "fps"):
        assert key in results, key
    assert np.isfinite(results["psnr"])
    # no weights or boxes here: explicit nulls
    for key in ("lpips", "dpsnr", "dssim", "dlpips"):
        assert results[key] is None


def test_eval_setup_loads_the_checkpoint_bit_for_bit(trained_run):
    _, config_path = trained_run
    config, trainer, step = eval_setup(config_path, "test", device="cpu")
    saved_step, saved = checkpoints.load_checkpoint(config_path.parent)
    assert (saved_step, step) == (1, 2) and trainer.state.step == 2
    got, want = tree_leaves(trainer.state.params), tree_leaves(saved["params"])
    assert len(got) == len(want) > 0
    assert all(torch.equal(a.detach(), b) for a, b in zip(got, want))
    assert config.load_dir == config_path.parent and config.vis == "none"
    assert trainer.test_mode == "test"
    assert trainer.datamanager.eval_split == "test"


def test_render_spiral_and_camera_path(trained_run, tmp_path):
    _, config_path = trained_run
    written = render_script.main([
        "--load-config", str(config_path), "--traj", "spiral",
        "--output-path", str(tmp_path / "spiral.mp4"), "--output-format", "images",
        "--interpolation-steps", "2", "--rendered-output-names", "rgb", "depth",
    ], device="cpu")
    frames = sorted((tmp_path / "spiral").glob("*.png"))
    assert written == tmp_path / "spiral" and len(frames) == 2

    # a hand-built viewer camera_path.json
    c2w = np.eye(4, dtype=np.float32)
    c2w[2, 3] = 2.0
    path = {
        "render_height": 24,
        "render_width": 32,
        "camera_path": [
            {"camera_to_world": c2w.reshape(-1).tolist(), "fov": 50.0},
            {"camera_to_world": c2w.reshape(-1).tolist(), "fov": 60.0},
        ],
    }
    path_file = tmp_path / "camera_path.json"
    path_file.write_text(json.dumps(path))
    render_script.main([
        "--load-config", str(config_path), "--traj", "filename",
        "--camera-path-filename", str(path_file),
        "--output-path", str(tmp_path / "traj.mp4"), "--output-format", "images",
    ], device="cpu")
    frames2 = sorted((tmp_path / "traj").glob("*.png"))
    assert len(frames2) == 2
    from PIL import Image

    assert Image.open(frames2[0]).size == (32, 24)


_REFUSE = """
import sys
from soccernerfs_tpu_torch.configs.cli import parse_train_cli
from soccernerfs_tpu_torch.utils.eval_utils import eval_setup
for call in (lambda: eval_setup(sys.argv[1], device="cpu"),
             lambda: parse_train_cli(["k-planes", "--load-config", sys.argv[1]])):
    try:
        call()
    except ValueError as e:
        print("refused:", e)
    else:
        print("loaded")
print("imported:", sorted(m for m in ("jax", "soccernerfs_tpu") if m in sys.modules))
"""


def test_a_jax_config_is_refused_without_importing_jax(tmp_path):
    """A config.yml that the JAX package's save_config wrote names
    soccernerfs_tpu classes: eval_setup and --load-config raise ValueError
    naming that module, and neither JAX nor the JAX package is imported (in
    a fresh process)."""
    cfg = copy.deepcopy(jax_registry["k-planes"])
    cfg.output_dir, cfg.timestamp = tmp_path, "jax"
    cfg.save_config()
    (path,) = tmp_path.glob("*/k-planes/jax/config.yml")
    proc = subprocess.run([sys.executable, "-c", _REFUSE, str(path)], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 3, proc.stdout
    assert all(line.startswith("refused:") and "soccernerfs_tpu." in line
               for line in lines[:2]), lines
    assert lines[2] == "imported: []"


def test_entry_points_need_cuda_unless_told(trained_run, tmp_path):
    """Without CUDA every entry point raises unless the caller names the
    CPU: none moves there on its own."""
    if torch.cuda.is_available():
        pytest.skip("needs a machine without CUDA")
    from soccernerfs_tpu_torch.core.camera_paths import get_path_from_json
    from soccernerfs_tpu_torch.viewer import server

    _, config_path = trained_run
    load = ["--load-config", str(config_path)]
    calls = [
        lambda: train_script.main(["k-planes-static", *E2E_FLAGS,
                                   "--output-dir", str(tmp_path), "blender-data",
                                   "--data", str(tmp_path)]),
        lambda: eval_script.main([*load, "--output-path", str(tmp_path / "r.json")]),
        lambda: render_script.main([*load, "--output-path", str(tmp_path / "o.mp4")]),
        lambda: server.main(load),
        lambda: eval_setup(config_path),
        lambda: dynmetric.DynMetric(),
        lambda: get_path_from_json({"render_height": 2, "render_width": 2,
                                    "camera_path": [{"camera_to_world": np.eye(
                                        4).reshape(-1).tolist(), "fov": 50.0}]}),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert not list(tmp_path.iterdir())


def test_profiler_times_and_traces(monkeypatch, capsys, tmp_path):
    """``time_function`` averages only while the profiler is on,
    ``flush_profiler`` prints the table, ``torch_trace`` writes a chrome
    trace."""
    from soccernerfs_tpu_torch.utils import profiler

    monkeypatch.setattr(profiler, "_STATS", {})
    monkeypatch.setattr(profiler, "_ENABLED", False)
    double = profiler.time_function(lambda x: 2 * x)
    assert double(2) == 4 and profiler._STATS == {}
    profiler.setup_profiler(True)
    assert double(3) == 6 and double(4) == 8
    ((name, (avg, n)),) = profiler._STATS.items()
    assert n == 2 and avg >= 0
    profiler.flush_profiler()
    assert "average call times" in capsys.readouterr().out
    with profiler.torch_trace(tmp_path / "trace"):
        torch.ones(8).sum()
    assert json.loads((tmp_path / "trace" / "trace.json").read_text())
