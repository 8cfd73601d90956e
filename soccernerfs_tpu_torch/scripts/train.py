"""snt-train: the training entry point (counterpart of
soccernerfs_tpu/scripts/train.py).

    python -m soccernerfs_tpu_torch.scripts.train k-planes \
        --pipeline.model.multiscale-res 1 2 4 8 16 \
        --pipeline.datamanager.ist-range 0.75 \
        broadcaststyle-data --fps-downsample 4 --data <path>

Trains on every local CUDA device (configs/cli.py has the grammar): one
process per device, the ray batch split over them (``parallel.mesh``).
``--machine.num-devices N`` takes N of them; ``--machine.force-shard-map
True`` takes the sharded path on one; across machines, each runs the same
command with ``--machine.num-machines M --machine.machine-rank R
--machine.coordinator <machine 0's host>:<port>``.  On one device without
``force_shard_map`` it trains in this process with no process group.
"""
from __future__ import annotations

import torch.distributed as dist

from soccernerfs_tpu_torch.configs.base import TrainerConfig
from soccernerfs_tpu_torch.configs.cli import parse_train_cli
from soccernerfs_tpu_torch.engine.trainer import Trainer
from soccernerfs_tpu_torch.parallel import mesh
from soccernerfs_tpu_torch.utils import profiler
from soccernerfs_tpu_torch.utils.device import resolve_device


def launch(fn, device, machine, args: tuple = ()):
    """``fn(device, *args)`` on the ranks that ``machine`` (a
    ``MachineConfig``) asks for, returning local rank 0's value: in this
    process with no process group for one device without
    ``force_shard_map``, else over ``parallel.mesh.spawn``.  Within a
    process group that the caller made, this rank's own value."""
    dev = resolve_device(device)
    if dist.is_initialized():
        return fn(dev, *args)
    nprocs = mesh.local_world_size(machine.num_devices, dev.type)
    if nprocs * machine.num_machines == 1 and not machine.force_shard_map:
        return fn(dev, *args)
    devices = ([f"cuda:{r}" for r in range(nprocs)] if dev.type == "cuda"
               else [dev] * nprocs)
    return mesh.spawn(fn, nprocs, args, devices=devices,
                      coordinator=machine.coordinator,
                      num_machines=machine.num_machines,
                      machine_rank=machine.machine_rank)[0]


def train_rank(device, config: TrainerConfig):
    """Set up and train on this rank; local rank 0 returns its Trainer."""
    try:
        trainer = Trainer(config, device=device).setup()
        trainer.train()
    finally:
        profiler.flush_profiler()
    return trainer if mesh.local_rank() == 0 else None


def main(argv=None, device=None) -> Trainer:
    """Parse ``argv`` (``sys.argv[1:]`` by default), train and return the
    trainer (local rank 0's).  ``device``: default CUDA; raises when CUDA
    is absent and the caller did not ask for another device ("cpu":
    ``--machine.num-devices N`` then runs N CPU ranks over gloo)."""
    config = parse_train_cli(argv)
    config.set_timestamp()
    if mesh.is_main_process() and config.machine.machine_rank == 0:
        print(f"[snt-train] method={config.method_name} "
              f"output={config.get_base_dir()}")
    return launch(train_rank, device, config.machine, (config,))


if __name__ == "__main__":
    main()
