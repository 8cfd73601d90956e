"""Buffered event writer with pluggable sinks (counterpart of
soccernerfs_tpu/utils/writer.py).

A module-level event buffer collects scalars, images and timings during a
step; ``write_out_storage`` flushes them to the active sinks (terminal,
tensorboard, wandb).  A sink whose package is missing prints that it is
unavailable and the terminal writer carries on.
"""
from __future__ import annotations

import enum
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np


class EventName(enum.Enum):
    """Standard event names (ref: utils/writer.py:43-54)."""

    ITER_TRAIN_TIME = "Train Iter (time)"
    TOTAL_TRAIN_TIME = "Train Total (time)"
    ITER_VIS_TIME = "Viewer Rendering (time)"
    ETA = "ETA (time)"
    TRAIN_RAYS_PER_SEC = "Train Rays / Sec"
    TEST_RAYS_PER_SEC = "Test Rays / Sec"
    VIS_RAYS_PER_SEC = "Vis Rays / Sec"
    CURR_TEST_PSNR = "Test PSNR"


EVENT_STORAGE: List[Dict[str, Any]] = []
_SINKS: List["Writer"] = []
_MAX_BUFFER = 20


def put_scalar(name, scalar, step: int):
    if isinstance(name, EventName):
        name = name.value
    EVENT_STORAGE.append(
        {"name": name, "write_type": "scalar", "event": float(scalar), "step": step}
    )


def put_dict(name: str, scalar_dict: Dict[str, Any], step: int):
    for k, v in scalar_dict.items():
        put_scalar(f"{name}/{k}", v, step)


def put_image(name, image: np.ndarray, step: int):
    if isinstance(name, EventName):
        name = name.value
    EVENT_STORAGE.append(
        {"name": name, "write_type": "image", "event": np.asarray(image), "step": step}
    )


def put_time(name, duration: float, step: int, avg_over_steps: bool = True):
    put_scalar(name, duration, step)


def write_out_storage():
    """Flush buffered events to all sinks (ref: utils/writer.py:155-188)."""
    for event in EVENT_STORAGE:
        for sink in _SINKS:
            if event["write_type"] == "scalar":
                sink.write_scalar(event["name"], event["event"], event["step"])
            elif event["write_type"] == "image":
                sink.write_image(event["name"], event["event"], event["step"])
    EVENT_STORAGE.clear()


class Writer:
    def write_scalar(self, name: str, scalar: float, step: int):
        raise NotImplementedError

    def write_image(self, name: str, image: np.ndarray, step: int):
        pass


class LocalWriter(Writer):
    """Terminal writer printing selected stats rows
    (ref: utils/writer.py:358-474, simplified to periodic stat lines)."""

    def __init__(self, max_log_freq: int = 10):
        self.max_log_freq = max_log_freq
        self.latest: Dict[str, float] = {}
        self.last_step = -1

    def write_scalar(self, name: str, scalar: float, step: int):
        self.latest[name] = scalar
        if step != self.last_step and step % self.max_log_freq == 0:
            self.last_step = step
            keys = [
                EventName.TRAIN_RAYS_PER_SEC.value,
                "Train Loss",
                EventName.ETA.value,
            ]
            parts = [f"step {step}"]
            for k in keys:
                if k in self.latest:
                    parts.append(f"{k}: {self.latest[k]:.4g}")
            print(" | ".join(parts), flush=True)


class TensorboardWriter(Writer):
    """(ref: utils/writer.py:306-356); requires the tensorboard package."""

    def __init__(self, log_dir: Path):
        from torch.utils.tensorboard import SummaryWriter  # type: ignore

        self.tb = SummaryWriter(log_dir=str(log_dir))

    def write_scalar(self, name, scalar, step):
        self.tb.add_scalar(name, scalar, step)

    def write_image(self, name, image, step):
        self.tb.add_image(name, np.transpose(image, (2, 0, 1)), step)


class WandbWriter(Writer):
    """(ref: utils/writer.py:281-304); requires wandb."""

    def __init__(self, log_dir: Path, name: Optional[str] = None):
        import wandb  # type: ignore

        wandb.init(project="soccernerfs-tpu", dir=str(log_dir), name=name, reinit=True)
        self.wandb = wandb

    def write_scalar(self, name, scalar, step):
        self.wandb.log({name: scalar}, step=step)

    def write_image(self, name, image, step):
        self.wandb.log({name: self.wandb.Image(image)}, step=step)


def setup_writers(vis: str, log_dir: Path, experiment_name: Optional[str] = None):
    """Select sinks from the --vis string (ref: engine/trainer.py:167-176)."""
    _SINKS.clear()
    _SINKS.append(LocalWriter())
    if "tensorboard" in vis:
        try:
            _SINKS.append(TensorboardWriter(log_dir))
        except Exception as e:  # tensorboard not installed
            print(f"[writer] tensorboard unavailable: {e}")
    if "wandb" in vis:
        try:
            _SINKS.append(WandbWriter(log_dir, experiment_name))
        except Exception as e:
            print(f"[writer] wandb unavailable: {e}")


class TimeWriter:
    """Context timer (ref: utils/writer.py:252-278)."""

    def __init__(self, writer_module=None, name=None, step: Optional[int] = None, write: bool = True):
        self.name = name
        self.step = step
        self.write = write
        self.duration = 0.0

    def __enter__(self):
        self.start = time.time()
        return self

    def __exit__(self, *args):
        self.duration = time.time() - self.start
        if self.write and self.name is not None and self.step is not None:
            put_time(self.name, self.duration, self.step)
