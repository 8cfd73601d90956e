"""Config tree (counterpart of soccernerfs_tpu/configs/base.py).

Typed dataclasses compose a method's config; ``TrainerConfig`` is the
root.  Dataparser and datamanager configs build their objects with
``.setup()``; models are named by their registry name.
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field
from datetime import datetime
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from soccernerfs_tpu_torch.data.datamanager import VanillaDataManagerConfig


@dataclass
class MachineConfig:
    """The port trains on one device: more devices or machines raise (the
    JAX package's ``parallel/mesh.py`` is not ported)."""

    seed: int = 42
    num_devices: int = -1
    num_machines: int = 1
    machine_rank: int = 0
    coordinator: Optional[str] = None

    def check_single_device(self) -> None:
        if self.num_devices > 1 or self.num_machines > 1:
            raise NotImplementedError(
                f"num_devices {self.num_devices}, num_machines "
                f"{self.num_machines}: training across devices needs "
                f"parallel/mesh.py, which the port does not have yet")


@dataclass
class LoggingConfig:
    steps_per_log: int = 10
    max_buffer_size: int = 20
    enable_profiler: bool = True


@dataclass
class ViewerConfig:
    relative_log_filename: str = "viewer_log_filename.txt"
    websocket_port: int = 7007
    num_rays_per_chunk: int = 32768
    max_num_display_images: int = 512
    quit_on_train_completion: bool = False


@dataclass
class PipelineConfig:
    """datamanager + model: ``model_name`` names the model module
    (``models/__init__.py``), ``model`` is that module's Config."""

    datamanager: VanillaDataManagerConfig = field(default_factory=VanillaDataManagerConfig)
    model_name: str = "kplanes"
    model: Any = None
    dynamic_batch: bool = False
    target_num_samples: int = 1 << 18
    max_num_samples_per_ray: int = 1024


@dataclass
class TrainerConfig:
    method_name: str = "base"
    experiment_name: Optional[str] = None
    timestamp: str = "{timestamp}"
    output_dir: Path = Path("outputs")
    vis: str = "wandb"
    data: Optional[Path] = None  # an alias for the dataparser's data

    steps_per_save: int = 1000
    steps_per_eval_batch: int = 500
    steps_per_eval_image: int = 500
    steps_per_eval_all_images: int = 25000
    max_num_iterations: int = 1000000
    mixed_precision: bool = False  # kept for parity; the bf16 policy is fixed
    save_only_latest_checkpoint: bool = True

    load_dir: Optional[Path] = None
    load_step: Optional[int] = None
    load_config: Optional[Path] = None

    machine: MachineConfig = field(default_factory=MachineConfig)
    logging: LoggingConfig = field(default_factory=LoggingConfig)
    viewer: ViewerConfig = field(default_factory=ViewerConfig)
    pipeline: PipelineConfig = field(default_factory=PipelineConfig)
    optimizers: Dict[str, Any] = field(default_factory=dict)

    def set_timestamp(self) -> None:
        if self.timestamp == "{timestamp}":
            self.timestamp = datetime.now().strftime("%Y-%m-%d_%H%M%S")

    def set_experiment_name(self) -> None:
        if self.experiment_name is None:
            dp = getattr(self.pipeline.datamanager, "dataparser", None)
            data = self.data or (dp.data if dp is not None else None)
            self.experiment_name = str(Path(data).stem) if data else "unnamed"

    def get_base_dir(self) -> Path:
        self.set_experiment_name()
        return Path(
            f"{self.output_dir}/{self.experiment_name}/{self.method_name}/{self.timestamp}"
        )

    def get_checkpoint_dir(self) -> Path:
        return self.get_base_dir() / "snt_models"

    def save_config(self) -> Path:
        """Write the whole config to ``{base_dir}/config.yml``."""
        import yaml

        base_dir = self.get_base_dir()
        base_dir.mkdir(parents=True, exist_ok=True)
        path = base_dir / "config.yml"
        path.write_text(yaml.dump(self), "utf8")
        return path

    def seed_everything(self, rank_offset: int = 0) -> None:
        """Seed Python's ``random``, numpy's global generator and torch's."""
        seed = self.machine.seed + rank_offset
        random.seed(seed)
        np.random.seed(seed)
        torch.manual_seed(seed)
