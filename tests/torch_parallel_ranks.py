"""What the spawned ranks of tests/test_torch_parallel.py run.

A spawned rank imports the module that holds its target, so these live
apart from the test files: nothing here imports JAX or the JAX package.
Every input comes as numpy arrays and port configs from the parent, and
every result goes back as numpy.
"""
from __future__ import annotations

import numpy as np
import torch

from soccernerfs_tpu_torch import convert
from soccernerfs_tpu_torch.core.cameras import Cameras
from soccernerfs_tpu_torch.engine.render import render_camera
from soccernerfs_tpu_torch.engine.trainer import TrainStep, step_seed
from soccernerfs_tpu_torch.parallel import mesh


def _np(t):
    return t.detach().cpu().numpy()


def _tensors(x, device):
    """numpy arrays (in lists and dicts) as tensors on ``device``."""
    if isinstance(x, dict):
        return {k: _tensors(v, device) for k, v in x.items()}
    if isinstance(x, list):
        return [_tensors(v, device) for v in x]
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.array(x)).to(device)
    return x


def _cameras(arrays: dict, device) -> Cameras:
    """Cameras of every field's numpy array (the JAX Cameras' fields)."""
    return Cameras(**{k: torch.from_numpy(np.array(v)).to(device)
                      for k, v in arrays.items()})


def _state_digests(state, world) -> np.ndarray:
    return mesh.check_replicated(state.tensors(), world.group)


def step_job(device, world, job: dict) -> dict:
    """One sharded step of JAX's draws for this rank's shard, then the
    update as ``TrainStep.train_iteration`` makes it (the model's state
    from a generator seeded alike on every rank), then one whole
    ``train_iteration`` from the port's own generators.  Returns the
    averaged loss terms, metrics and gradients of the first step and the
    ranks' state digests after each."""
    cams = _cameras(job["cameras"], device)
    ts = TrainStep(job["cfg"], cams, job["aabb"], job["optimizers"], device,
                   model=job["model"], camera_optimizer=job["camera_optimizer"],
                   world=world)
    aux = convert.aux_from_jax(job["aux"], device) if job["aux"] else None
    state = ts.init_state(convert.params_from_jax(job["params"], device), aux)
    state.step = job["step"]
    shard = job["shards"][world.rank]
    batch = _tensors(shard["batch"], device)
    loss, loss_dict, metrics, grads = ts.averaged_loss_and_grads(
        state, batch, train_proposal_networks=job["flag"],
        **_tensors(shard["draws"], device))
    out = {"loss": float(loss),
           "loss_dict": {k: float(v) for k, v in loss_dict.items()},
           "metrics": {k: float(v) for k, v in metrics.items()},
           "grads": [_np(g) for g in grads]}
    step = state.step
    ts.apply_grads(state, grads)
    if hasattr(ts.model, "update_aux"):
        gen = torch.Generator(device=device).manual_seed(step_seed(0, step))
        state.aux = ts.model.update_aux(ts.cfg, state.params, ts.aabb, step,
                                        state.aux, gen)
    out["digests"] = _state_digests(state, world)
    gens = [torch.Generator(device=device).manual_seed(step_seed(0, state.step, s))
            for s in (world.rank, None)]
    ts.train_iteration(state, batch, gens[0], aux_generator=gens[1])
    out["iteration_digests"] = _state_digests(state, world)
    out["aux"] = {k: _np(v) for k, v in state.aux.items()}
    return out


def render_job(device, world, job: dict) -> dict:
    """A whole image rendered over the world and by this rank alone, per
    chunk size."""
    params = convert.params_from_jax(
        convert.seeded_params(job["cfg"], 0, time_noise=0.05), device)
    cams = _cameras(job["cameras"], device)
    out = {}
    for chunk in job["chunks"]:
        for name, w in (("sharded", world), ("direct", None)):
            img = render_camera(job["cfg"], params, cams, 0, chunk, device,
                                aabb=job["aabb"], model="kplanes", world=w)
            out[(name, chunk)] = {k: _np(v) for k, v in img.items()}
    return out


def all_mean_job(device, world, job: dict) -> list:
    """``all_mean`` of tensors that differ by rank: f32 and bf16 of many
    sizes (one past the bucket size), an int64, and a None on rank 1."""
    rng = np.random.default_rng(world.rank)
    like = [torch.zeros(s) for s in job["shapes"]]
    tensors = [torch.from_numpy(rng.normal(size=s).astype(np.float32))
               for s in job["shapes"]]
    tensors[job["none_at"]] = None if world.rank == 1 else tensors[job["none_at"]]
    tensors.append(torch.tensor(3 + world.rank, dtype=torch.int64))
    like.append(torch.zeros((), dtype=torch.int64))
    tensors.append(torch.from_numpy(rng.normal(size=7).astype(np.float32))
                   .to(torch.bfloat16))
    like.append(torch.zeros(7, dtype=torch.bfloat16))
    mine = [None if t is None else t.float().numpy().copy() for t in tensors]
    mean = mesh.all_mean(tensors, world.group, like=like)
    return [mine, [t.float().numpy() for t in mean],
            [str(t.dtype) for t in mean]]


JOBS = {"step": step_job, "render": render_job, "all_mean": all_mean_job}


def run_jobs(device, jobs: list) -> list:
    """Every job on this rank, in order, one torch thread."""
    torch.set_num_threads(1)
    world = mesh.current_world()
    return [JOBS[job["kind"]](device, world, job) for job in jobs]


def fail_on_rank(device, failing_rank: int) -> None:
    """One all-reduce, then the failing rank raises while the others wait
    in a second one."""
    t = torch.ones(4)
    torch.distributed.all_reduce(t)
    if mesh.rank() == failing_rank:
        raise ValueError(f"rank {failing_rank} fails on purpose")
    torch.distributed.all_reduce(t)


def train_machine(argv: list) -> None:
    """``snt-train`` on the CPU with one torch thread: one machine of a
    multi-machine run."""
    from soccernerfs_tpu_torch.scripts import train

    torch.set_num_threads(1)
    train.main(argv, device="cpu")


# ---------------------------------------------------------------------------
# tests/test_torch_parallel_entry_points.py: snt-render, snt-export and the
# viewer over a world of ranks
# ---------------------------------------------------------------------------

def _post(url, payload, timeout=120):
    """(status, body) of a JSON POST; an HTTP error's status and body."""
    import json
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as reply:
            return reply.status, reply.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _get_json(url):
    import json
    import urllib.request

    with urllib.request.urlopen(url, timeout=120) as reply:
        return json.loads(reply.read())


# the viewer's requests: a /render at 16x12 and one at 8x6 (c2w from the
# first training camera), a path job of two frames, then a path job of
# PATH_CANCEL_FRAMES frames cancelled at once
VIEWER_SIZES = ((16, 12), (8, 6))
PATH_CANCEL_FRAMES = 41


def viewer_client(server) -> dict:
    """Drive a serving viewer: the /render PNGs at VIEWER_SIZES, a path job
    of two frames (its status once finished), and a path job of
    PATH_CANCEL_FRAMES frames cancelled right after it starts (its status
    once stopped).  Returns the PNGs' bytes, both statuses and the
    seconds from the last request to return."""
    import time

    state = server.viewer_state
    url = f"http://127.0.0.1:{server.server_address[1]}"
    c2w = state.trainer.train_cameras.camera_to_worlds[0].tolist()
    out = {"png": []}
    for width, height in VIEWER_SIZES:
        status, body = _post(f"{url}/render", {"c2w": c2w, "fov": 50.0,
                                               "width": width, "height": height})
        assert status == 200, body
        out["png"].append(body)
    for k in range(2):
        c = [list(row) for row in c2w]
        c[0][3] += 0.1 * k
        _post(f"{url}/keyframe", {"c2w": c, "fov": 50.0})

    def finished():
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            status = _get_json(f"{url}/render_status")
            if not status["running"]:
                return status
            time.sleep(0.02)
        raise TimeoutError("the path job did not end")

    for job, steps in (("path", 1), ("cancelled", PATH_CANCEL_FRAMES - 1)):
        status, body = _post(f"{url}/render_path", {
            "width": 8, "height": 6, "fps": 2, "steps_per_transition": steps})
        assert status == 200, body
        if job == "cancelled":
            _post(f"{url}/cancel_render", {})
        out[job] = finished()
    out["t_last"] = time.monotonic()
    return out


def failing_viewer_client(server) -> dict:
    """One /render of a viewer whose render fails on some rank: its
    status and body."""
    state = server.viewer_state
    url = f"http://127.0.0.1:{server.server_address[1]}"
    c2w = state.trainer.train_cameras.camera_to_worlds[0].tolist()
    status, body = _post(f"{url}/render", {"c2w": c2w, "fov": 50.0,
                                           "width": 8, "height": 6})
    return {"status": status, "body": body}


class _Recorder:
    """Spies on this rank: every ``Trainer.render_camera`` (its camera as
    host arrays, its outputs), every ``density_volume``, every
    ``render_trajectory``'s cameras, and every file write (a PNG, a PLY,
    a JSON, a video)."""

    def __init__(self):
        import pathlib

        from PIL import Image

        from soccernerfs_tpu_torch.engine.trainer import Trainer
        from soccernerfs_tpu_torch.scripts import exporter
        from soccernerfs_tpu_torch.scripts import render as render_script
        from soccernerfs_tpu_torch.viewer.dispatch import host_camera

        self.renders, self.volumes, self.trajectories, self.writes = [], [], [], []
        self._saved = []

        def spy(obj, name, make):
            fn = getattr(obj, name)
            self._saved.append((obj, name, fn))
            setattr(obj, name, make(fn))

        def render(fn):
            def wrapper(trainer, cameras, index, chunk=None):
                out = fn(trainer, cameras, index, chunk)
                self.renders.append((host_camera(cameras, index), out))
                return out
            return wrapper

        def volume(fn):
            def wrapper(*args, **kwargs):
                out = fn(*args, **kwargs)
                self.volumes.append(out[0])
                return out
            return wrapper

        def trajectory(fn):
            def wrapper(trainer, cameras, *args, **kwargs):
                self.trajectories.append(
                    [host_camera(cameras, i) for i in range(cameras.num_cameras)])
                return fn(trainer, cameras, *args, **kwargs)
            return wrapper

        def write(kind):
            def make(fn):
                def wrapper(target, *args, **kwargs):
                    self.writes.append((kind, str(target)))
                    return fn(target, *args, **kwargs)
                return wrapper
            return make

        spy(Trainer, "render_camera", render)
        spy(exporter, "density_volume", volume)
        spy(render_script, "render_trajectory", trajectory)
        spy(exporter, "write_ply", write("ply"))
        spy(Image.Image, "save", write("image"))
        spy(pathlib.Path, "write_text", write("text"))

    def restore(self):
        for obj, name, fn in reversed(self._saved):
            setattr(obj, name, fn)


def _state_bytes(trainer) -> list:
    """Every tensor of the trainer's state as its bytes (bf16 included)."""
    return [t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy()
            for t in trainer.state.tensors()]


def live_viewer_run(device, config_argv: list, render: bool) -> dict:
    """``snt-train``'s Trainer on this rank of the world, ``config_argv``
    parsed; with ``render``, rank 0's client asks its live viewer for a
    /render before the loop starts (the loop serves it after step 0).
    Counts the broadcasts of the viewer's messages and the world renders
    on this rank; returns them, the final state (rank 0) and what the
    client got."""
    import threading
    import time

    import torch.distributed as dist

    from soccernerfs_tpu_torch.configs.cli import parse_train_cli
    from soccernerfs_tpu_torch.engine.trainer import Trainer

    trainer = Trainer(parse_train_cli(config_argv), device=device).setup()
    broadcasts = []
    saved = dist.broadcast_object_list

    def counted(*args, **kwargs):
        broadcasts.append(1)
        return saved(*args, **kwargs)

    dist.broadcast_object_list = counted
    reply = {}
    client = None
    try:
        server = trainer.viewer_server
        if render and server is not None:
            url = f"http://127.0.0.1:{server.server_address[1]}"
            c2w = trainer.train_cameras.camera_to_worlds[0].tolist()
            client = threading.Thread(target=lambda: reply.update(zip(
                ("status", "body"), _post(f"{url}/render", {
                    "c2w": c2w, "fov": 50.0, "width": 16, "height": 12}))))
            client.start()
            deadline = time.monotonic() + 60
            while trainer.dispatcher.pending() < 1:
                if time.monotonic() > deadline:
                    raise TimeoutError("the live viewer's /render was not queued")
                time.sleep(0.01)
        trainer.train()
        if client is not None:
            client.join(60)
    finally:
        dist.broadcast_object_list = saved
        if trainer.viewer_server is not None:
            trainer.viewer_server.shutdown()
            trainer.viewer_server.server_close()
    return {"broadcasts": len(broadcasts),
            "renders": (0 if trainer.dispatcher is None
                        else trainer.dispatcher.renders),
            "has_dispatcher": trainer.dispatcher is not None,
            "served": trainer.viewer_server is not None,
            "reply": reply, "steps": trainer.state.step,
            "state": _state_bytes(trainer) if mesh.rank() == 0 else None}


def entry_points_job(device, job: dict) -> dict:
    """On this rank of a world of two: snt-render, the five snt-export
    subcommands and the standalone viewer on ``job["config"]``'s run (each
    ``main`` in this group: ``launch`` runs it on this rank), the live
    viewer's two training runs, and a render of ``job["camera"]`` at
    ``job["params"]`` over the world (the JAX comparison).  Returns what
    each main returned on this rank and what the spies saw."""
    from soccernerfs_tpu_torch.scripts import exporter
    from soccernerfs_tpu_torch.scripts import render as render_script
    from soccernerfs_tpu_torch.viewer import server as viewer

    torch.set_num_threads(1)
    world = mesh.current_world()
    out = {}
    rec = _Recorder()
    try:
        value = render_script.main(job["render_argv"], device=device)
        out["render"] = {"value": value, "trajectories": rec.trajectories,
                         "renders": rec.renders[:], "writes": rec.writes[:]}
        for cmd, argv in job["export_argv"].items():
            for seen in (rec.renders, rec.volumes, rec.writes):
                seen.clear()
            value = exporter.main(argv, device=device)
            out[cmd] = {"value": value, "renders": rec.renders[:],
                        "volumes": rec.volumes[:], "writes": rec.writes[:]}
        rec.writes.clear()
        served = viewer.main(job["viewer_argv"], device=device,
                             on_serve=viewer_client if world.rank == 0 else None)
        out["viewer"] = {"value": served, "writes": rec.writes[:]}
    finally:
        rec.restore()
    out["live"] = [live_viewer_run(device, argv, render)
                   for argv, render in job["live"]]
    params = convert.params_from_jax(job["params"], device)
    img = render_camera(job["cfg"], params, _cameras(job["camera"], device), 0,
                        None, device, aabb=job["aabb"], model="kplanes",
                        world=world)
    out["jax_render"] = {k: _np(v) for k, v in img.items()}
    return out


def failing_entry_job(device, entry: str, argv: list, failing_rank: int):
    """``entry``'s main (render or viewer) on this rank of a world, the
    failing rank's ``Trainer.render_camera`` raising before its
    collective."""
    from soccernerfs_tpu_torch.engine.trainer import Trainer
    from soccernerfs_tpu_torch.scripts import render as render_script
    from soccernerfs_tpu_torch.viewer import server as viewer

    torch.set_num_threads(1)
    saved = Trainer.render_camera

    def fail(*args, **kwargs):
        raise ValueError(f"rank {failing_rank} fails on purpose")

    if mesh.rank() == failing_rank:
        Trainer.render_camera = fail
    try:
        if entry == "render":
            return render_script.main(argv, device=device)
        return viewer.main(argv, device=device, on_serve=(
            failing_viewer_client if mesh.rank() == 0 else None))
    finally:
        Trainer.render_camera = saved
