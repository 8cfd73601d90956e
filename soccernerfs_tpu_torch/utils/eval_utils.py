"""Rebuilding a trained run for eval, render and the viewer (counterpart of
soccernerfs_tpu/utils/eval_utils.py).

``eval_setup`` reads a run's ``config.yml`` (``configs.base.load_config``:
only the port's classes, so a config of the JAX package raises
ValueError), rebuilds its Trainer without writing to the run, and loads
the latest (or the given) checkpoint.  Within a process group (snt-eval
over several ranks) every rank does so, and the Trainer's renders split
over the ranks.
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple

from soccernerfs_tpu_torch.configs.base import TrainerConfig, load_config
from soccernerfs_tpu_torch.engine.trainer import Trainer


def eval_setup(
    config_path: Path,
    test_mode: str = "test",
    load_step: Optional[int] = None,
    device=None,
) -> Tuple[TrainerConfig, Trainer, int]:
    """(config, trainer at the checkpoint's state, the state's step).

    Args:
        config_path: a run's ``config.yml``; its checkpoints are beside it.
        test_mode: "test" (snt-eval) or "inference" (snt-render, the
            viewer): either way the datamanager's eval split is the parser's
            "test" split, and nothing is written to the run.  The image
            caches decode at setup only the splits that fit in one cached
            batch (``num_images_to_sample_from`` -1 or at least the split),
            as the JAX package's do; a larger train split is decoded only
            when a train batch is asked for.
        load_step: the checkpoint's step; the latest when None.
        device: default CUDA; raises when CUDA is absent and the caller
            did not ask for another device.
    """
    config_path = Path(config_path)
    config = load_config(config_path)
    base_dir = config_path.parent
    config.load_dir = base_dir
    config.load_step = load_step
    config.vis = "none"
    trainer = Trainer(config, test_mode=test_mode, device=device)
    trainer.base_dir = base_dir
    trainer.setup()
    return config, trainer, int(trainer.state.step)
