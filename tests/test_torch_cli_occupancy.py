"""The occupancy-grid methods through the port's entry points on the CPU:
``snt-train`` (``scripts/train.py``) of instant-ngp-bounded and
nerfplayer-ngp on a small broadcaststyle scene, past a grid update; then
``eval_setup``, whose state must hold the trained grid exactly (it reaches
the renders through the checkpoint's ``aux``) and whose render must equal
the trainer's own render of the same state; ``snt-eval`` and
``snt-render``'s spiral over the snapshot.

Small flags: 16^3 grids, 64 probes and 12 samples per ray, hash grids to
128 at 2^12 rows, 64-ray batches, 18 steps (a grid update at step 16).
"""
import json

import numpy as np
import pytest
import torch

from soccernerfs_tpu_torch.data.fixtures import make_broadcaststyle_fixture
from soccernerfs_tpu_torch.engine import checkpoints
from soccernerfs_tpu_torch.scripts import eval as eval_script
from soccernerfs_tpu_torch.scripts import render as render_script
from soccernerfs_tpu_torch.scripts import train as train_script
from soccernerfs_tpu_torch.utils.eval_utils import eval_setup
from soccernerfs_tpu_torch.utils.tree import tree_leaves


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch CPU thread while this file runs (the suite runs in
    parallel worker processes, whose default thread pools oversubscribe
    the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


STEPS = 18
_OCC_FLAGS = [
    "--max-num-iterations", str(STEPS),
    "--steps-per-save", str(STEPS),
    "--vis", "none",
    "--pipeline.model.grid-resolution", "16",
    "--pipeline.model.num-probes-per-ray", "64",
    "--pipeline.model.max-num-samples-per-ray", "12",
    "--pipeline.model.max-res", "128",
    "--pipeline.model.log2-hashmap-size", "12",
    "--pipeline.model.eval-num-rays-per-chunk", "256",
    "--pipeline.datamanager.train-num-rays-per-batch", "64",
    "--pipeline.datamanager.eval-num-rays-per-batch", "64",
    "--pipeline.datamanager.train-num-images-to-sample-from", "-1",
    "--pipeline.datamanager.eval-num-images-to-sample-from", "-1",
]
FLAGS = {
    "instant-ngp-bounded": _OCC_FLAGS,
    "nerfplayer-ngp": [*_OCC_FLAGS, "--pipeline.model.num-levels", "4",
                       "--pipeline.model.temporal-dim", "8"],
}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return make_broadcaststyle_fixture(tmp_path_factory.mktemp("bstyle"),
                                       num_cameras=3, num_steps=3, h=12, w=16)


@pytest.fixture(scope="module", params=sorted(FLAGS))
def trained(request, data, tmp_path_factory):
    method = request.param
    out = tmp_path_factory.mktemp(method)
    trainer = train_script.main(
        [method, *FLAGS[method], "--output-dir", str(out / "outputs"),
         "broadcaststyle-data", "--data", str(data)], device="cpu")
    return method, out, trainer


def test_training_updates_the_grid(trained):
    """The run reached its last step; the grid moved off its zeros at the
    all-cells updates and is checkpointed with the params."""
    method, _, trainer = trained
    assert trainer.state.step == STEPS
    occs = trainer.state.aux["occs"]
    assert occs.shape == (16**3,) and float(occs.abs().max()) > 0
    step, saved = checkpoints.load_checkpoint(trainer.base_dir)
    assert step == STEPS - 1
    assert torch.equal(saved["aux"]["occs"], occs)


def test_eval_setup_holds_the_grid_and_renders_the_same(trained):
    """eval_setup's state is the trained one: the grid exactly (dtype,
    device, values), every param bit for bit, the step; and its render of
    an eval camera equals the trainer's own render of the state it
    saved, on the same device."""
    method, _, trainer = trained
    config, loaded, step = eval_setup(trainer.base_dir / "config.yml", device="cpu")
    assert step == STEPS and config.method_name == method
    got, want = loaded.state.aux["occs"], trainer.state.aux["occs"]
    assert got.dtype == want.dtype == torch.float32 and got.device == want.device
    assert torch.equal(got, want)
    for a, b in zip(tree_leaves(loaded.state.params),
                    tree_leaves(trainer.state.params), strict=True):
        assert torch.equal(a.detach(), b.detach())
    mine = trainer.render_camera(trainer.eval_cameras, 0)
    theirs = loaded.render_camera(trainer.eval_cameras, 0)
    assert set(mine) == set(theirs)
    for k in mine:
        np.testing.assert_array_equal(theirs[k], mine[k], err_msg=k)
    # the grid matters: an empty one renders another image
    empty = loaded.train_step.model.init_aux(loaded.model_cfg, "cpu")
    loaded.state.aux = empty
    blank = loaded.render_camera(trainer.eval_cameras, 0)
    assert not np.array_equal(blank["accumulation"], mine["accumulation"])


def test_eval_and_render_scripts(trained):
    """snt-eval writes its JSON with finite PSNR and render rate; snt-render
    writes a 2-frame spiral at the eval cameras' size."""
    method, out, trainer = trained
    config_path = trainer.base_dir / "config.yml"
    info = eval_script.main(["--load-config", str(config_path), "--output-path",
                             str(out / "r.json")], device="cpu")
    payload = json.loads((out / "r.json").read_text())
    assert payload["method_name"] == method == info["method_name"]
    assert np.isfinite(payload["results"]["psnr"])
    assert payload["results"]["num_rays_per_sec"] > 0
    written = render_script.main([
        "--load-config", str(config_path), "--traj", "spiral",
        "--output-path", str(out / "spiral.mp4"), "--output-format", "images",
        "--interpolation-steps", "2", "--rendered-output-names", "rgb",
        "accumulation"], device="cpu")
    frames = sorted(written.glob("*.png"))
    assert len(frames) == 2
    from PIL import Image

    size = Image.open(frames[0]).size
    cams = trainer.eval_cameras
    assert size == (2 * int(cams.width[0]), int(cams.height[0]))
