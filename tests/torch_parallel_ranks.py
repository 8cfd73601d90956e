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


def viewer_rank(device, config) -> bool:
    """Set up a Trainer whose ``vis`` names the viewer; rank 0 serves it and
    renders a view through it, alone (a collective there would wait for
    the other rank, which is in the barrier below), then every rank meets
    at a barrier.  Returns whether this rank served a PNG."""
    from soccernerfs_tpu_torch.engine.trainer import Trainer

    torch.set_num_threads(1)
    trainer = Trainer(config, device=device).setup()
    served = trainer.viewer_server is not None
    if served:
        c2w = np.eye(4, dtype=np.float32)[:3]
        c2w[2, 3] = 3.0
        png = trainer.viewer_server.viewer_state.render(c2w, 50.0, 16, 12)
        trainer.viewer_server.shutdown()
        served = png.startswith(b"\x89PNG")
    torch.distributed.barrier()
    return served
