"""snt-train: the training entry point (counterpart of
soccernerfs_tpu/scripts/train.py).

    python -m soccernerfs_tpu_torch.scripts.train k-planes \
        --pipeline.model.multiscale-res 1 2 4 8 16 \
        --pipeline.datamanager.ist-range 0.75 \
        broadcaststyle-data --fps-downsample 4 --data <path>

Trains on one CUDA device (configs/cli.py has the grammar).
"""
from __future__ import annotations

from soccernerfs_tpu_torch.configs.cli import parse_train_cli
from soccernerfs_tpu_torch.engine.trainer import Trainer
from soccernerfs_tpu_torch.utils import profiler


def main(argv=None, device=None) -> Trainer:
    """Parse ``argv`` (``sys.argv[1:]`` by default), train and return the
    trainer.  ``device``: default CUDA; raises when CUDA is absent and the
    caller did not ask for another device."""
    config = parse_train_cli(argv)
    config.set_timestamp()
    print(f"[snt-train] method={config.method_name} output={config.get_base_dir()}")
    try:
        trainer = Trainer(config, device=device).setup()
        trainer.train()
    finally:
        profiler.flush_profiler()
    return trainer


if __name__ == "__main__":
    main()
