"""The paper's 21 sweeps as data (counterpart of the drivers in the
repository's ``experiments/``): each entry holds a driver's Experiment
arguments, parameter sets and run flags, and ``main`` runs one of them.
Every driver module is ``main("<its name>")``:

    python -m soccernerfs_tpu_torch.experiments.kp_res_study \\
        [--data DIR] [--cam-path FILE] [--runs I [I ...]] \\
        [--train-args "--max-num-iterations 32"] [--render-args ARGS] \\
        [--eval-args ARGS]

Without arguments a driver runs the JAX driver's commands with the
port's modules; ``--data`` is appended to the dataparser's arguments,
``--cam-path`` replaces the camera path, ``--runs`` picks parameter sets
by index, and the ``--*-args`` strings are split and added to every
command of their kind (snt_experiment.Experiment's ``extra_args``).
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Optional, Sequence

from soccernerfs_tpu_torch.experiments.snt_experiment import Experiment

STADIUM_PATH = "data/stadium/camera_paths/nicecam.json"
_TV = "pipeline.model.loss-coefficients"
_DM = "pipeline.datamanager"
_KP_RES = {"pipeline.model.feature-dim": "32",
           "pipeline.model.spacetime-resolution": "64 64 64 100"}


def _sweep(cam_path, model, dataset, params, data_params=None,
           do_render=True) -> dict:
    return {"cam_path": cam_path, "model": model, "dataset": dataset,
            "params": params, "data_params": data_params,
            "do_render": do_render}


# driver name -> its sweep; every driver evaluates each run
DRIVERS: Dict[str, dict] = {
    "depth_loss_coeff": _sweep(
        "data/broadcaststyle/camera_paths/main.json", "k-planes",
        "broadcaststyle-data --depth-maps depth-maps",
        [{f"{_TV}.depth-loss": w} for w in (0.0, 0.01, 0.05, 0.1, 0.5)]),
    "hypernerf_kplanes": _sweep(
        None, "k-planes", "hypernerf-data",
        [{"pipeline.model.bounded": "false"},
         {"pipeline.model.bounded": "true"}], do_render=False),
    "isg": _sweep(
        STADIUM_PATH, "k-planes", "stadium-data",
        [{f"{_DM}.isg": "true", f"{_DM}.isg-gamma": g} for g in (1e-2, 5e-2, 1e-1)]
        + [{f"{_DM}.isg": "false", f"{_DM}.ist-range": "1.0"}]),
    "ist_isg": _sweep(
        STADIUM_PATH, "k-planes", "stadium-data",
        [{f"{_DM}.isg": "false", f"{_DM}.ist-range": 1.0},
         {f"{_DM}.isg": "true", f"{_DM}.isg-gamma": 5e-2},
         {f"{_DM}.isg": "true", f"{_DM}.isg-gamma": 5e-2,
          f"{_DM}.iters-to-start-is": 1000}]),
    # the paper's resolution study (section 5.3.5)
    "kp_res_study": _sweep(
        STADIUM_PATH, "k-planes", "stadium-data",
        [{**_KP_RES, "pipeline.model.multiscale-res": "1 2 4 8"},
         {**_KP_RES, "pipeline.model.multiscale-res": "1 2 4 8 16"},
         {**_KP_RES, "pipeline.model.multiscale-res": "1 2 4 8 16 32",
          "pipeline.model.feature-dim": "24"}]),
    "kp_spacetv": _sweep(
        STADIUM_PATH, "k-planes", "stadium-data",
        [{f"{_TV}.space-tv-loss": w, f"{_TV}.space-tv-proposal-loss": w}
         for w in (0.0, 0.0002, 0.002, 0.02, 0.2)]),
    "kp_sparsetransients": _sweep(
        STADIUM_PATH, "k-planes", "stadium-data",
        [{f"{_TV}.sparse-transients-loss": w} for w in (0.0, 0.0001, 0.001, 0.01)]),
    "kp_temporal_res": _sweep(
        STADIUM_PATH, "k-planes", "stadium-data",
        [{"pipeline.model.spacetime-resolution": f"64 64 64 {t}"}
         for t in (25, 50, 100, 200)]),
    "kp_temporalsmoothness": _sweep(
        STADIUM_PATH, "k-planes", "stadium-data",
        [{f"{_TV}.time-smoothness-loss": w} for w in (0.0, 0.001, 0.1, 1.0, 10.0)]),
    "kplanes_net": _sweep(
        STADIUM_PATH, "k-planes", "stadium-data",
        [{"pipeline.model.sigma-net-hidden-dim": s,
          "pipeline.model.rgb-net-hidden-dim": r}
         for (s, r) in ((64, 64), (128, 64), (128, 128), (256, 128))]),
    "np_synth_paderborn": _sweep(
        None, "nerfplayer", "stadiumwide-data",
        [{"pipeline.model.prob-reg-loss-mult": w} for w in (0.0001, 0.01, 0.1)],
        do_render=False),
    "sp_imgres": _sweep(
        STADIUM_PATH, "k-planes", "stadium-data", [{}] * 3,
        data_params=[{"downscale-factor": d} for d in (1, 2, 4)]),
    "sp_npnerfacto": _sweep(
        STADIUM_PATH, "nerfplayer-nerfacto", "stadium-data",
        [{"pipeline.model.temporal-dim": t} for t in (16, 32, 64, 128)]),
    "sp_res_kp": _sweep(
        STADIUM_PATH, "k-planes", "stadium-data",
        [{"pipeline.model.spacetime-resolution": f"{r} {r} {r} 100"}
         for r in (32, 64, 128)]),
    "stadium_imgres": _sweep(
        STADIUM_PATH, "k-planes", "stadium-data", [{}] * 3,
        data_params=[{"downscale-factor": d} for d in (1, 2, 4)]),
    "stadium_is": _sweep(
        STADIUM_PATH, "k-planes", "stadium-data",
        [{f"{_DM}.is-pixel-ratio": r, f"{_DM}.ist-range": rng}
         for r in (0.05, 0.15, 0.3) for rng in (0.25, 0.5, 1.0)]),
    "stadium_size": _sweep(
        STADIUM_PATH, "k-planes", "stadium-data", [{}] * 3,
        data_params=[{"scene-scale": s} for s in (1.0, 1.5, 2.0)]),
    # the JAX driver's 'stadiumplayers-data' is absent from its registry;
    # the stadium parser covers that scene, as there
    "stadiumplayersIS": _sweep(
        STADIUM_PATH, "k-planes", "stadium-data",
        [{f"{_DM}.use-importance-sampling": "false"},
         {f"{_DM}.is-pixel-ratio": 0.075},
         {f"{_DM}.is-pixel-ratio": 0.15},
         {f"{_DM}.is-pixel-ratio": 0.3}]),
    "stadiumplayers_closeup": _sweep(
        None, "k-planes", "stadiumwide-data", [{}] * 2,
        data_params=[{"closeup-training": v} for v in ("false", "true")],
        do_render=False),
    "stadiumplayers_imgres": _sweep(
        STADIUM_PATH, "k-planes", "stadium-data", [{}] * 2,
        data_params=[{"downscale-factor": d} for d in (2, 4)]),
    "stadiumplayers_nb_cams": _sweep(
        STADIUM_PATH, "k-planes", "stadium-data", [{}] * 4,
        data_params=[{"train-split-percentage": p} for p in (0.25, 0.5, 0.75, 0.95)]),
}


def experiment(name: str, *, data: Optional[str] = None, cam_path=None,
               runs: Optional[Sequence[int]] = None,
               extra_args: Optional[Dict[str, Sequence[str]]] = None
               ) -> Experiment:
    """Driver ``name``'s Experiment with its parameter sets (the ones at
    ``runs`` when given), ``--data <data>`` after the dataparser's
    arguments and ``cam_path`` in place of the driver's, when given."""
    sweep = DRIVERS[name]
    dataset = sweep["dataset"] + (f" --data {data}" if data else "")
    exp = Experiment(name, cam_path if cam_path is not None else sweep["cam_path"],
                     sweep["model"], dataset, extra_args=extra_args)
    params, data_params = sweep["params"], sweep["data_params"]
    if runs is not None:
        params = [params[i] for i in runs]
        data_params = data_params and [data_params[i] for i in runs]
    exp.set_params(params, data_params=data_params)
    return exp


def main(name: str, argv: Optional[List[str]] = None) -> None:
    """Run driver ``name``'s sweep (train, render where it has a camera
    path, eval) from a command line (module docstring)."""
    parser = argparse.ArgumentParser(
        prog=f"python -m soccernerfs_tpu_torch.experiments.{name}",
        description=f"The {name} sweep on the port's entry points.")
    parser.add_argument("--data", default=None,
                        help="scene root, appended to the dataparser's arguments")
    parser.add_argument("--cam-path", default=None,
                        help="camera path file for the renders")
    parser.add_argument("--runs", type=int, nargs="+", default=None,
                        help="indices of the parameter sets to run")
    for kind in ("train", "render", "eval"):
        parser.add_argument(f"--{kind}-args", default="",
                            help=f"arguments added to every {kind} command")
    args = parser.parse_args(argv)
    extra = {kind: getattr(args, f"{kind}_args").split()
             for kind in ("train", "render", "eval")}
    exp = experiment(name, data=args.data, cam_path=args.cam_path,
                     runs=args.runs, extra_args=extra)
    exp.run(do_eval=True, do_render=DRIVERS[name]["do_render"])
