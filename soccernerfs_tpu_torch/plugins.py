"""Method plugins from installed packages (counterpart of
soccernerfs_tpu/plugins.py).

A third-party package registers a method under the
``soccernerfs_tpu_torch.method_configs`` entry-point group; each entry
point resolves to a ``MethodSpecification`` (or a callable returning one)
whose ``TrainerConfig`` joins ``configs/method_configs.trainer_configs``.
A model module of its own is named with ``models.register_model``.
Discovery errors are printed, not raised: a broken plugin leaves the
registered methods usable.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

from soccernerfs_tpu_torch.configs.base import TrainerConfig

GROUP = "soccernerfs_tpu_torch.method_configs"


@dataclass
class MethodSpecification:
    config: TrainerConfig
    description: str = ""


def discover_methods() -> Tuple[Dict[str, TrainerConfig], Dict[str, str]]:
    """The methods and descriptions of every installed entry point of
    ``GROUP``, by method name."""
    methods: Dict[str, TrainerConfig] = {}
    descriptions: Dict[str, str] = {}
    try:
        from importlib.metadata import entry_points

        for ep in entry_points().select(group=GROUP):
            spec = ep.load()
            if callable(spec):
                spec = spec()
            if not isinstance(spec, MethodSpecification):
                raise TypeError(f"entry point {ep.name} must resolve to a "
                                "MethodSpecification")
            methods[spec.config.method_name] = spec.config
            descriptions[spec.config.method_name] = spec.description
    except Exception as e:  # a broken plugin must not break the CLI
        print(f"[plugins] method discovery failed: {e}")
    return methods, descriptions
