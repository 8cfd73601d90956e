"""``snt-train`` and ``snt-eval`` over several ranks on the CPU (gloo): the
port's entry points spawn their local ranks (``parallel.mesh.spawn``),
rank 0 in this process; a second "machine" is a spawned process joining
over ``--machine.coordinator 127.0.0.1:<free port>``.

- ``--machine.num-devices 2`` on the blender fixture: one ``config.yml``,
  one dataparser transform and the checkpoints, all in rank 0's run
  directory; every tensor of the state
  bit-equal across the ranks at the end (``Trainer.replica_digests``).
- A resume from that checkpoint at world size 2, then 1.
- Two machines of one rank each: the same final state, bit for bit, as
  ``num-devices 2``; the second machine writes nothing.
- ``snt-eval`` at world size 2: the metrics of world size 1 (the renders
  agree within 1e-5, so PSNR within 1e-4 dB and SSIM within 1e-5).
- (The viewer over ranks, live and standalone, is
  tests/test_torch_parallel_entry_points.py's.)
- Refusals: a batch that the world size does not divide, and
  ``num_machines > 1`` without a coordinator.
"""
import json
import multiprocessing
import socket

import numpy as np
import pytest
import torch

from soccernerfs_tpu_torch.data.fixtures import make_blender_fixture
from soccernerfs_tpu_torch.parallel import mesh
from soccernerfs_tpu_torch.pipelines import average_eval_image_metrics
from soccernerfs_tpu_torch.scripts import eval as eval_script
from soccernerfs_tpu_torch.scripts import train as train_script
from soccernerfs_tpu_torch.utils.eval_utils import eval_setup
from soccernerfs_tpu_torch.utils.tree import tree_leaves
import torch_parallel_ranks as ranks

STEPS = 4
FLAGS = [
    "--vis", "terminal",
    "--max-num-iterations", str(STEPS),
    "--steps-per-save", "2",
    "--pipeline.model.spacetime-resolution", "8", "8", "8",
    "--pipeline.model.multiscale-res", "1", "2",
    "--pipeline.model.feature-dim", "4",
    "--pipeline.model.num-proposal-samples-per-ray", "8", "6",
    "--pipeline.model.num-nerf-samples-per-ray", "4",
    "--pipeline.model.sigma-net-hidden-dim", "16",
    "--pipeline.model.rgb-net-hidden-dim", "16",
    "--pipeline.datamanager.train-num-rays-per-batch", "64",
    "--pipeline.model.eval-num-rays-per-chunk", "128",
]
# a spawned machine's join, far above what it takes here
JOIN_S = 120


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch CPU thread while this file runs, and so in every rank it
    spawns (the suite runs in parallel worker processes, whose default
    thread pools oversubscribe the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _argv(out, data, *extra, timestamp="run"):
    return ["k-planes-static", *FLAGS, "--output-dir", str(out),
            "--timestamp", timestamp, *extra, "blender-data", "--data", str(data)]


def _state(trainer):
    return [t.detach().clone() for t in trainer.state.tensors()]


@pytest.fixture(scope="module")
def world_two(tmp_path_factory):
    root = tmp_path_factory.mktemp("world_two")
    data = make_blender_fixture(root / "data")
    trainer = train_script.main(
        _argv(root / "out", data, "--machine.num-devices", "2"), device="cpu")
    return root, data, trainer


def test_train_at_world_two_writes_once_and_stays_replicated(world_two):
    root, _, trainer = world_two
    assert trainer.world == mesh.World(rank=0, size=2)
    assert not mesh.current_world()      # the group is gone after the run
    assert trainer.state.step == STEPS
    files = [p for p in (root / "out").rglob("*") if p.is_file()]
    assert all(trainer.base_dir in p.parents for p in files)
    assert (trainer.base_dir / "config.yml").is_file()
    assert (trainer.base_dir / "dataparser_transforms.json").is_file()
    # the registry keeps every checkpoint: the save at step 2 and the last
    assert sorted(p.name for p in (trainer.base_dir / "snt_models").iterdir()) == [
        "step-000000002.pt", "step-000000003.pt"]
    digests = trainer.replica_digests
    assert digests.shape[:2] == (2, len(trainer.state.tensors()))
    np.testing.assert_array_equal(digests[0], digests[1])
    assert all(torch.isfinite(t).all() for t in tree_leaves(trainer.state.params))


@pytest.mark.parametrize("devices", [2, 1])
def test_resume_at_world_two_then_one(world_two, devices, tmp_path):
    _, data, trainer = world_two
    resumed = train_script.main(
        _argv(tmp_path / "out", data, "--machine.num-devices", str(devices),
              "--max-num-iterations", str(STEPS + 2), "--load-dir",
              str(trainer.base_dir)), device="cpu")
    assert resumed.state.step == STEPS + 2
    assert (resumed.world is None) == (devices == 1)
    assert all(torch.isfinite(t).all() for t in tree_leaves(resumed.state.params))
    if devices == 2:
        d = resumed.replica_digests
        np.testing.assert_array_equal(d[0], d[1])


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_machines_equal_two_devices(world_two, tmp_path):
    _, data, trainer = world_two
    machines = ["--machine.num-devices", "1", "--machine.num-machines", "2",
                "--machine.coordinator", f"127.0.0.1:{_free_port()}"]
    other = multiprocessing.get_context("spawn").Process(
        target=ranks.train_machine,
        args=(_argv(tmp_path / "out", data, *machines,
                    "--machine.machine-rank", "1", timestamp="machine1"),))
    other.start()
    try:
        mine = train_script.main(
            _argv(tmp_path / "out", data, *machines, "--machine.machine-rank",
                  "0", timestamp="machine0"), device="cpu")
    finally:
        other.join(JOIN_S)
        if other.is_alive():
            other.kill()
    assert other.exitcode == 0
    assert mine.world == mesh.World(rank=0, size=2)
    for a, b in zip(_state(mine), _state(trainer), strict=True):
        assert torch.equal(a, b)
    runs = sorted(p.parent.name for p in (tmp_path / "out").rglob("config.yml"))
    assert runs == ["machine0"]
    assert not list((tmp_path / "out").rglob("machine1"))


def test_eval_at_world_two_matches_world_one(world_two, tmp_path):
    _, _, trainer = world_two
    config_path = trainer.base_dir / "config.yml"
    info = eval_script.main(["--load-config", str(config_path),
                             "--output-path", str(tmp_path / "r.json"),
                             "--no-dynmetric"], device="cpu")
    assert json.loads((tmp_path / "r.json").read_text()) == info
    _, single, step = eval_setup(config_path, "test", device="cpu")
    assert single.world is None and info["checkpoint"] == str(step)
    want = average_eval_image_metrics(single)
    got = info["results"]
    assert set(got) == set(want)
    assert abs(got["psnr"] - want["psnr"]) <= 1e-4
    assert abs(got["ssim"] - want["ssim"]) <= 1e-5
    assert got["lpips"] is want["lpips"] is None


def test_refusals(tmp_path):
    data = make_blender_fixture(tmp_path / "data", num_frames=2, h=12, w=12)
    with pytest.raises(ValueError, match="does not split over 2 ranks"):
        train_script.main(_argv(tmp_path / "out", data,
                                "--machine.num-devices", "2",
                                "--pipeline.datamanager.train-num-rays-per-batch",
                                "63"), device="cpu")
    assert not mesh.current_world()
    with pytest.raises(ValueError, match="coordinator"):
        train_script.main(_argv(tmp_path / "out", data,
                                "--machine.num-machines", "2"), device="cpu")
