"""Experiment sweep harness (counterpart of experiments/snt_experiment.py).

Drives parameter sweeps by running the port's ``snt-train``,
``snt-render`` and ``snt-eval`` entry points
(``python -m soccernerfs_tpu_torch.scripts.{train,render,eval}``) in
subprocesses, one run per parameter set, grouped under one experiment
name with a param-slug timestamp: the JAX harness's surface and
commands, with the port's modules.  The entry points run on the CUDA
device.

Example:

    exp = Experiment("kp_res_study", "camera_path.json", "k-planes",
                     "broadcaststyle-data --data /data/broadcaststyle")
    exp.set_params([
        {"pipeline.model.multiscale-res": "1 2 4"},
        {"pipeline.model.multiscale-res": "1 2 4 8 16"},
    ])
    exp.run(do_eval=True)

``extra_args`` adds arguments to every command of a kind: ``"train"``'s
go before the dataparser (e.g. ``["--max-num-iterations", "32"]``),
``"render"``'s and ``"eval"``'s at the end.  Without them the commands are
the JAX harness's, module for module.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Optional, Sequence

OUTPUT_ROOT = Path(os.environ.get("SNT_EXPERIMENTS_ROOT", "outputs"))
PY = sys.executable
SCRIPTS = "soccernerfs_tpu_torch.scripts"


class Experiment:
    """One sweep: a model, a dataset, and a list of param dicts."""

    def __init__(self, name: str, cam_path, model: str, dataset: str = "",
                 extra_args: Optional[Dict[str, Sequence[str]]] = None):
        self.name = name
        self.cam_path = cam_path
        self.model = model
        self.dataset = dataset
        self.extra_args = {k: [str(a) for a in v]
                           for k, v in (extra_args or {}).items()}
        unknown = set(self.extra_args) - {"train", "render", "eval"}
        if unknown:
            raise ValueError(f"extra_args for unknown commands: {sorted(unknown)}")
        self.params: Optional[List[Dict]] = None
        self.data_params: Optional[List[Dict]] = None
        self._active_params: Optional[Dict] = None
        self._active_data_params: Optional[Dict] = None
        for sub in ("", "renders", "evals"):
            (self.get_path() / sub).mkdir(parents=True, exist_ok=True)

    def set_params(self, params: List[Dict], data_params=None):
        """Every run's dotted train flags (and, per run or for all, the
        dataparser's); writes them to ``params.json``."""
        self.params = [{k: str(v) for k, v in p.items()} for p in params]
        if data_params is not None:
            if isinstance(data_params, dict):
                self.data_params = [
                    {k: str(v) for k, v in data_params.items()}
                ] * len(params)
            else:
                self.data_params = [
                    {k: str(v) for k, v in p.items()} for p in data_params
                ]
        (self.get_path() / "params.json").write_text(json.dumps(self.params, indent=4))

    def run(self, do_eval: bool = False, do_render: bool = True):
        """Train (then render and eval) every parameter set."""
        assert self.params is not None, "Params not set"
        for i, param in enumerate(self.params):
            self._active_params = param
            if self.data_params is not None:
                self._active_data_params = self.data_params[i]
            self._train()
            if do_render and self.cam_path:
                self._render()
            if do_eval:
                self._eval()

    # -- steps --------------------------------------------------------------
    def _sh(self, cmd: List[str]):
        print("Running:", " ".join(cmd), flush=True)
        subprocess.run(cmd, check=False)

    def _train(self):
        assert self._active_params is not None
        cmd = [PY, "-m", f"{SCRIPTS}.train", self.model]
        for k, v in self._active_params.items():
            cmd += [f"--{k}"] + str(v).split()
        cmd += ["--experiment-name", self.name, "--timestamp", self._timestamp()]
        cmd += ["--output-dir", str(OUTPUT_ROOT)]
        cmd += self.extra_args.get("train", [])
        if self.dataset:
            cmd += self.dataset.split()
        if self._active_data_params is not None:
            for k, v in self._active_data_params.items():
                cmd += [f"--{k}"] + str(v).split()
        self._sh(cmd)

    def _render(self):
        cam_paths = self.cam_path if isinstance(self.cam_path, list) else [self.cam_path]
        for i, path in enumerate(cam_paths):
            self._sh(
                [
                    PY, "-m", f"{SCRIPTS}.render",
                    "--load-config", str(self.get_config_path()),
                    "--traj", "filename",
                    "--camera-path-filename", str(path),
                    "--output-path", str(self.get_render_path(i)),
                    *self.extra_args.get("render", []),
                ]
            )

    def _eval(self):
        self._sh(
            [
                PY, "-m", f"{SCRIPTS}.eval",
                "--load-config", str(self.get_config_path()),
                "--output-path", str(self.get_eval_path()),
                *self.extra_args.get("eval", []),
            ]
        )

    # -- paths --------------------------------------------------------------
    def get_path(self) -> Path:
        return OUTPUT_ROOT / self.name

    def get_run_path(self) -> Path:
        return self.get_path() / self.model / self._timestamp()

    def get_config_path(self) -> Path:
        return self.get_run_path() / "config.yml"

    def get_render_path(self, cam_path_id: int = 0) -> Path:
        if isinstance(self.cam_path, list):
            stem = Path(self.cam_path[cam_path_id]).stem
            return self.get_path() / "renders" / self._timestamp() / f"{stem}.mp4"
        return self.get_path() / "renders" / f"{self._timestamp()}.mp4"

    def get_eval_path(self) -> Path:
        return self.get_path() / "evals" / f"{self._timestamp()}.json"

    def _timestamp(self) -> str:
        assert self._active_params is not None
        values = list(self._active_params.values())
        if self._active_data_params is not None:
            values += list(self._active_data_params.values())
        slug = "-".join(str(v).replace(".", "_").replace(" ", "_") for v in values)
        return slug or "default"
