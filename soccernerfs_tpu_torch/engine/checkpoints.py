"""Checkpoints (counterpart of soccernerfs_tpu/engine/checkpoints.py).

``{base_dir}/snt_models/step-{step:09d}.pt`` holds, through ``torch.save``,
the train state as CPU tensors: {"step", "steps_since_update", "params",
"opt_state", "aux"}, with each Adam group as {"count", "mu", "nu"} in its
storage dtypes (K-Planes' bf16 first moments round-trip bit for bit).
``save_only_latest`` removes older steps.
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple

import torch

CKPT_DIR_NAME = "snt_models"


def checkpoint_dir(base_dir: Path) -> Path:
    return Path(base_dir) / CKPT_DIR_NAME


def checkpoint_path(base_dir: Path, step: int) -> Path:
    return checkpoint_dir(base_dir) / f"step-{step:09d}.pt"


def to_cpu(tree):
    """A copy of a nested dict/list of tensors with every tensor on the
    CPU, detached."""
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_cpu(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return tree


def save_checkpoint(base_dir: Path, step: int, state: dict,
                    save_only_latest: bool = False) -> Path:
    """Write ``state`` (nested dicts/lists of tensors and numbers) as the
    checkpoint of ``step``; returns its path."""
    path = checkpoint_path(base_dir, step)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".tmp")
    torch.save(to_cpu(state), tmp)
    tmp.replace(path)
    if save_only_latest:
        for other in path.parent.glob("step-*.pt"):
            if other != path:
                other.unlink()
    return path


def latest_checkpoint_step(base_dir: Path) -> Optional[int]:
    root = checkpoint_dir(base_dir)
    if not root.exists():
        return None
    steps = sorted(int(p.stem.split("-")[-1]) for p in root.glob("step-*.pt"))
    return steps[-1] if steps else None


def load_checkpoint(base_dir: Path, step: Optional[int] = None
                    ) -> Tuple[int, dict]:
    """(step, state) of the checkpoint of ``step``, the latest when None;
    tensors on the CPU."""
    if step is None:
        step = latest_checkpoint_step(base_dir)
        if step is None:
            raise FileNotFoundError(
                f"no checkpoints under {checkpoint_dir(base_dir)}")
    state = torch.load(checkpoint_path(base_dir, step), map_location="cpu",
                       weights_only=True)
    return step, state
