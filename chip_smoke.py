#!/usr/bin/env python3
"""Drive the PyTorch port (soccernerfs_tpu_torch) on one CUDA card and check it.

  1. Prints the card's name and power limit (nvidia-smi).
  2. Builds the CUDA kernels from soccernerfs_tpu_torch/csrc, one nvcc per
     source, all started together.
  3. Kernel phases, at the main paths' shapes, CUDA events, L2 flushed: each
     kernel against its plain PyTorch version, timed beside it and beside a
     library yardstick.  Forward plane kernels (relative max error <= 1e-5;
     yardstick torch.nn.functional.grid_sample); backward plane kernels
     (atomics: 1e-5 of the max; aten.grid_sampler_2d_backward) on uniform
     random points and on every launch of one K-Planes train step,
     captured at the wrappers (the path's own ray-ordered operands), with
     each case's vector reductions and their rate;
     scatter_add_rows (atomics: 1e-6 of the largest row's sum of |terms|,
     or no further from the f64 sum than index_add_'s f32 sum of the same
     updates; index_add_ on the pre-expanded update stream) on uniform
     random points:
     one hashed and one dense level of nerfacto's main grid, the same level
     as sorted_scatter_add takes it (expanded, sorted), one proposal level,
     the whole-grid launches the train path makes, a wider row, a 2-row
     table with 100,000 updates, an empty update list; then on the
     launches of one train step of each hash-grid method, captured at the
     wrapper: nerfacto's 3, depth-nerfacto's 3 (on a batch with target
     depths), nerfplayer-nerfacto's 3 width-1 launches over
     the flattened temporal tables, nerfplayer's 6 (its stationary grid's
     two, one per encode, the newness and decomposition grids' width-1
     launches and the two proposal grids'), instant-ngp-bounded's one over
     its static grid, nerfplayer-ngp's one width-1 launch over its
     temporal grid and nerfplayer-ngp-complete's 4; each with its L2
     reductions (scatter_plan) and their rate.  A case's time is the
     median of five passes of 20 launches.  The render path's fused plane
     kernel (kplanes_fwd_fused, one launch per K-Planes scale) on its own
     operands: chunk 0 of camera 0's frame, captured at the wrapper for
     the main field's five scales and proposal_0, bit-equal to its plain
     version (within 1e-5 relative), timed beside the per-plane route it
     replaced (grid_coords, bilerp_fwd_* per plane group, the in-place
     product, the column copy) and grid_sample per plane shape with the
     product, against the coordinates, features and touched table rows.
     Then the five plane kernels at the other feature widths (16, 24 and
     48, compiled; 20, padded to 24), on three [100, 2048] time planes of
     kp_res_study's finest scale at the render path's field point count:
     each against its plain version and timed beside its library call.
  4. Render phases, ``k-planes``, ``nerfacto``, ``depth-nerfacto`` (nerfacto's
     forward), ``nerfplayer-nerfacto``
     (temporal hash grids), ``nerfplayer`` (the decomposition field), then
     the occupancy-grid methods ``instant-ngp-bounded``, ``nerfplayer-ngp``
     and ``nerfplayer-ngp-complete``, full registry width,
     weights drawn from a numpy seed and loaded through ``params_from_jax``
     (the occupancy methods' grid state from one all-cells update at those
     weights): two counted 960x540 frames through ``render_camera``
     (K-Planes fails unless the fused plane kernel launched and no
     per-plane forward kernel did; the profiled frame's fused time against
     its in-frame byte bound), two timed
     frames, one profiled with torch.profiler; then one 4096-ray chunk on
     the CPU (the kernels' plain versions) against the card, a random
     background handed to both sides as the same draws, an occupancy
     method's binary grid too (the rays whose samples differ are counted,
     at most 0.1 %, and left out of the comparison); a NeRFPlayer
     method's rendered component probabilities are compared beside rgb.
  5. Train phases, ``k-planes``, ``nerfacto`` (camera optimizer SO3xR3
     on, as registered), ``depth-nerfacto`` (the same, its batches carrying
     target depths, 10 % of them 0, for the DS-NeRF loss on every level;
     scatter_add_rows must launch 3 times per update step and once per
     other step), ``nerfplayer-nerfacto`` (camera optimizer off,
     the temporal TV over its three grids), ``nerfplayer`` (the TV over its
     four temporal grids, the probability regulariser), then
     ``instant-ngp-bounded``, ``nerfplayer-ngp`` and
     ``nerfplayer-ngp-complete`` (8192-ray batches; the grid updated after the
     optimizer step every 16 steps, over all cells before step 256):
     ``TrainStep.train_iteration`` on batches of bench.py's 20-camera
     ring, steps 0-11 (all update the proposals; an occupancy method's
     step 0 updates its grid) and a steady window at step 10,000 (60
     steps, a proposal update every sixth; 64 for an occupancy method, a
     grid update every sixteenth); fails unless the path's kernels
     launched (K-Planes: all four plane kernels; the hash-grid methods:
     scatter_add_rows on every step), the loss and every gradient are
     finite and the parameters, the camera optimizer's included, and an
     occupancy method's grid moved.
     Prints ms per update and non-update step, train rays/s over the window
     and its sub-windows (12 steps; an occupancy method's 16), the
     process's CPU time per step and peak memory, and traces one step of
     each kind with torch.profiler; for K-Planes, each plane kernel's
     device time in a profiled step beside the byte bound of the captured
     step's launches (the counts must match), and for the hash-grid
     methods scatter_add_rows' the same way.  The scatter's deferred range
     check (``scatter_kernels.raise_if_out_of_range``) runs wherever a
     step's loss is read on the host: after every synchronised step, and
     after each step of the CPU checks.
  6. Train CPU checks: one 1024-ray step with the same params, batch and
     draws on the card and on the CPU; the loss terms and every gradient
     before the update agree (per leaf, in L2).  For K-Planes (TF32 turned
     on before its steps, which must compute in f32 all the same and leave
     it on) and depth-nerfacto, two more CPU steps per seed, one with the
     card's PDF bins and one that also moves the ray directions by one
     ulp, which show what the resampling adds and how far the step moves
     on the CPU alone.  For an occupancy
     method, at step 272, whose grid update is a sampled one: the rays
     whose samples differ are counted (at most 0.1 %), and both sides
     update the same grid from the card's updated params with the same
     draws; the grids agree within 1e-5 in L2.
     The classic methods, ``tensorf`` (VM tables at their final
     300^3), ``vanilla-nerf`` and ``mipnerf``, whose paths run no
     hand-written kernel: render (TensoRF two counted frames, a timed and a
     profiled one; the NeRF methods one counted frame), a chunk against the
     CPU, the train phase above at the registry's batches, and a CPU check
     of one step (1024 rays for TensoRF, 256 for the NeRF methods) with
     the witnesses, each leaf held with the card's bins on both sides
     within 1e-2 or twice its one-ulp witness.

  7. Trainer phases, through ``Trainer(config).setup().train()`` with the
     registered ``trainer_configs``, on fixtures the script writes to a
     temporary directory: ``trainer_kplanes`` (k-planes at
     full width on a broadcaststyle scene of 20 cameras x 10 steps at
     540x960: the image cache picks 95 images every 16 steps, IST weights
     computed on the card at each refresh, IST rays from step 8; 64 steps
     with eval batches, an eval image and checkpoints; all four plane
     kernels must launch; a fresh Trainer resumed from the final checkpoint
     must hold a bit-equal state and runs to step 96),
     ``trainer_kplanes_depth`` (k-planes on the same fixture's depth maps,
     32 steps: depth_loss finite and positive at every log step, the depth
     maps decoded at each refresh), ``trainer_ingp_bounded``
     (48 steps with ``dynamic_batch``, its bucket changes printed;
     scatter_add_rows must launch) and ``convergence_kplanes_static``
     (tests/test_convergence.py's run: k-planes-static on the blender
     fixture, 300 steps; held-out PSNR > 20.5 and SSIM > 0.44).  Each prints
     a JSON line: rays/s of the loop with its data path beside TrainStep's
     window, the sampler's host ms per step before and after IST starts,
     ms per cache refresh (decode, IST), checkpoint save and load ms, the
     eval image's PSNR, peak memory, and 8 more steps split into sampler,
     batch copy and train step, each synchronised.
  8. The CLI phase, ``cli_kplanes``, on the same fixture and in process:
     ``scripts.train.main`` trains k-planes at registry width from a
     command line (the ``trainer_kplanes`` data overrides as flags, 16
     steps, the checkpoint of step 15); ``scripts.eval.main`` writes
     ns-eval's JSON, with DynMetric's boxes from a sidecar file (one around
     the ball per eval image); the viewer's server
     (``viewer.server.make_server`` on a free port of 127.0.0.1) answers
     /scene, four /render requests (rgb and depth at 240x135 and 960x540),
     three /keyframe and an /export_path; ``scripts.render.main`` renders
     an 8-frame spiral (rgb, depth, accumulation side by side), an
     interpolated path and the exported camera_path.json as PNG frames.
     Fails unless all four train plane kernels launched in training and
     the fused one, and no per-plane forward kernel, in eval, in the
     viewer's /render requests and in render, and every JSON, PNG and
     frame has its keys and size.  Prints
     the loop's rays/s, eval rays/s and fps, s/frame per trajectory, ms
     per /render by size (the first apart), ``eval_setup`` ms and peak
     memory.  Then ``cli_depth_nerfacto``: ``snt-train depth-nerfacto ...
     nerfstudio-data`` on a 20-frame nerfstudio-format ring with depth maps
     at 540x960, its registered live viewer on a free port answering
     /render at 240x135 while the trainer lives, ``snt-eval`` and
     ``snt-render``'s spiral; scatter_add_rows 3 launches per update step
     and 1 per other step.
  9. The classic methods', HyperNeRF data's and the occupancy entry
     points' Trainer and CLI phases: ``trainer_tensorf`` (tensorf at
     registry width on a blender fixture, 48 steps, its five upsampling
     steps compressed to 8-40: the tables reach 300^3, every optimizer
     state restarts at each, the final checkpoint reloads through
     ``eval_setup`` and renders what the trainer rendered; each upsample's
     time), ``trainer_kplanes_hypernerf`` (k-planes with ``bounded``
     false on a HyperNeRF capture it writes, 2 sides x 20 times at
     540x960 with distortion, 32 steps with IST from 16, one eval image;
     all four plane kernels), ``cli_ingp_bounded`` (snt-train
     instant-ngp-bounded with its live viewer answering mid-run, the
     snapshot's grid and render equal to the trainer's, snt-eval,
     snt-render's spiral, the viewer on the snapshot; scatter_add_rows)
     and ``cli_dnerf`` (snt-train dnerf on a D-NeRF layout it writes,
     snt-eval, a 4-frame spiral).
 10. The last two methods and the exporter.  ``semantic-nerfw``'s method
     phases after depth-nerfacto's: nerfacto's forward plus the semantic
     head (100 classes, chunk 2^16), render and its CPU check with the
     composited logits beside rgb, the scatter's launches of a step,
     train on batches with random labels (3 scatter launches per update
     step, 1 otherwise), a 1024-ray CPU check.  ``neus``'s after the
     classic methods: one counted 960x540 frame at chunk 1024 (the SDF's
     normals inside the render's no_grad), a 256-ray chunk against the
     CPU with its normals, train (1024 rays, the eikonal loss's double
     backward), a 256-ray CPU check of the step with the card's sampler
     bins on both sides and the witnesses.  Among the Trainer phases:
     ``trainer_semantic_nerfw`` (Trainer.train on a Sitcoms3D capture it
     writes, 20 x 270x480 with labels, 24 steps, then snt-eval),
     ``cli_neus`` (snt-train neus 16 steps on a 10-frame 270x480
     nerfstudio ring, snt-eval, a 2-frame spiral) and ``cli_export``
     (``scripts.exporter``'s pointcloud, cameras, marching-cubes, tsdf
     and poisson at their defaults on ``cli_kplanes``' snapshot, and
     marching-cubes at the density's median on a 32^3 grid, each timed,
     with the plane kernels it launched counted: the fused one in every
     subcommand but cameras, no per-plane forward kernel).
 11. A user's own capture and the remaining dataparsers, after
     ``cli_export``.  ``cli_process_data``: a COLMAP binary model of 20
     OPENCV cameras (small k1, k2, p1, p2) on a ring around the ball
     scene with their 270x480 renders, through
     ``scripts.process_data.main(["colmap-to-json", ...])``; the
     nerfstudio parser must read back the ring's poses after its
     orientation and scale (1e-5) and each frame's distortion; then
     ``snt-train nerfacto`` (camera optimizer on, as registered) on it, 64
     steps with an eval image at step 32, ``snt-eval`` on the snapshot,
     and ``images --skip-colmap --camera-type equirectangular`` on one
     seeded 512x1024 panorama (8 crops of the size
     ``compute_resolution_from_equirect`` picks).  ``trainer_parsers``:
     ``Trainer.train`` at registry width, 8 steps each, on fixtures of
     each parser that reads local files: instant-ngp-data (instant-ngp),
     dycheck-data (k-planes on its times), sdfstudio-data (neus), and
     minimal-parser, phototourism-data, scannet-data and arkitscenes-data
     (nerfacto).  Each fails unless its losses are finite, every param
     group moved and the scatter's range check passes.
 12. ``sweep_kp_res``, last: the paper's resolution study through the
     ported sweep harness (``experiments.sweeps``, ``snt_experiment``):
     kp_res_study's third run (k-planes at F = 24 over scales 1..32,
     ~0.43 G parameters) on the Trainer phases' fixture, 32 steps, the
     render of a two-frame camera path and snt-eval, each command in its
     own process reporting its kernels' launches by feature width (F = 24
     must launch); then ``scripts.plot_kplane`` on the snapshot,
     ``scripts.compute_ist`` on the fixture, and the snapshot's render on
     1024 rays against the CPU.
Prints a JSON line with the six kernels' results, the card line, and last
``{"ok": true, "device": {...}}``.  Any failure exits non-zero before the
last line.  Needs CUDA and this repository around it.

Usage (from the repository root):
    python3 chip_smoke.py [--trace DIR]
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
H100_BYTES_PER_S = 3.35e12       # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12           # f32 outside the tensor cores
KERNEL_REL_TOL = 1e-5
SEED = 0
H, W = 540, 960
DEVICE = "cuda"
MODEL = "k-planes"
NERFACTO = "nerfacto"
DEPTH = "depth-nerfacto"
NERFPLAYER = "nerfplayer-nerfacto"
INGP = "instant-ngp-bounded"
NPNGP = "nerfplayer-ngp"
NP = "nerfplayer"
NPNGPC = "nerfplayer-ngp-complete"
AABB = [[-1.5] * 3, [1.5] * 3]
TRAIN_CPU_RAYS = 1024
TRAIN_CPU_SEEDS = (2,)           # numpy seeds of the draws; the batch's is + 1
NERFACTO_CPU_SEEDS = (2,)
DEPTH_CPU_SEEDS = (2,)
DEPTH_ZEROS = 0.1                # share of a depth batch's rays without a target
NERFPLAYER_CPU_SEEDS = (2,)      # both temporal proposal methods
OCC_CPU_SEEDS = (2,)
OCC_CPU_STEP = 272               # a sampled grid update
TRAIN_WINDOW = 60                # steps, 10 update cycles
OCC_TRAIN_WINDOW = 64            # steps, 4 grid-update cycles
SELECTION_TOL = 1e-3             # share of rays whose samples may differ
OCCS_L2_TOL = 1e-5               # card vs CPU grid after an update, in L2
GRAD_L2_TOL = 1e-2               # card vs CPU, each gradient leaf in L2
# the decomposition field's deformation MLP, whose gradient is the deformed
# encode's position gradient (train_cpu_check says why it is held apart)
DEFORM_PREFIX = "fields/deformation_field/"
DEFORM_L2_TOL = 5e-2
# of the largest row's sum of |terms|, or index_add_'s own f32 error on
# the same updates where that is larger (scatter_case)
SCATTER_MASS_TOL = 1e-6
BWD_PASSES = 5                   # timing passes per backward or scatter case
# the Trainer phases: a broadcaststyle scene of 20 cameras (Camera_1-19
# train, Camera_20 eval) x 10 time steps at scene 2's working resolution
STATIC = "k-planes-static"
TRAINER_FIXTURE = {"num_cameras": 20, "num_steps": 10, "h": 540, "w": 960}
# the cache picks 5 time steps of the 19 train cameras and keeps them 16
# steps; IST weights from the first refresh, IST rays from step 8
TRAINER_DATA = {"train_num_images_to_sample_from": 95,
                "train_num_times_to_repeat_images": 16,
                "iters_to_start_is": 8}
# checkpoints are ~1.6 GB: keep the latest only
TRAINER_LOOP = {"max_num_iterations": 64, "steps_per_save": 32,
                "steps_per_eval_image": 32, "steps_per_eval_batch": 32,
                "vis": "none", "save_only_latest_checkpoint": True}
TRAINER_LOG_STEPS = 8
TRAINER_RESUME_TO = 96
# k-planes on the same fixture with its depth maps (the depth loss's
# targets), as experiments/depth_loss_coeff.py trains it
TRAINER_DEPTH_STEPS = 32
TRAINER_KPLANES = {}              # trainer_kplanes' loop rate and refreshes
INGP_TRAINER_STEPS = 48
# tests/test_convergence.py's run: its model and batch overrides, 300 steps
CONVERGENCE_MODEL = {"spacetime_resolution": (16, 16, 16),
                     "multiscale_res": (1, 2), "feature_dim": 8,
                     "num_proposal_samples_per_ray": (24, 16),
                     "num_nerf_samples_per_ray": 16,
                     "sigma_net_hidden_dim": 32, "rgb_net_hidden_dim": 32}
CONVERGENCE_RAYS = 512
CONVERGENCE_STEPS = 300
CONVERGENCE_GATE = (20.5, 0.44)   # held-out PSNR and SSIM must exceed these
WINDOW_RAYS_PER_S = {}            # train_phase's window rate per method
# the CLI phase, on the Trainer phases' fixture: snt-train's steps (one
# checkpoint, at the last), the spiral's and interpolated path's frames,
# the exported path's frames per keyframe transition, the viewer's
# /render sizes (width, height), each asked for rgb and depth
CLI_STEPS = 16
CLI_RENDER_STEPS = 8
CLI_PATH_STEPS = 2
VIEWER_SIZES = ((240, 135), (960, 540))
# the nerfacto family through the entry points: depth-nerfacto on a
# nerfstudio-format ring of 20 frames (18 train, 2 eval) with depth maps
NERFSTUDIO_FIXTURE = {"num_frames": 20, "h": 540, "w": 960}
# the classic methods: no hand-written kernel on their paths
TENSORF = "tensorf"
VNERF = "vanilla-nerf"
MIPNERF = "mipnerf"
DNERF = "dnerf"
CLASSIC_STEP = 10_000             # the windows' step: past every upsample
CLASSIC_CPU_RAYS = {TENSORF: 1024, VNERF: 256, MIPNERF: 256}
CLASSIC_CPU_SEEDS = (2,)
# counted render frames (cameras), timed ones, and whether one is profiled
# (none: TensoRF's frame of ~84 k kernels took 45.5 s to profile)
CLASSIC_FRAMES = {TENSORF: ((0, 1), (1,), False), VNERF: ((1,), (), False),
                  MIPNERF: ((1,), (), False)}
TENSORF_FIXTURE = {"num_frames": 8, "h": 200, "w": 200}
TENSORF_TRAINER_ITERS = (8, 16, 24, 32, 40)   # the registry's 2000-7000
TENSORF_TRAINER_STEPS = 48
HYPERNERF_FIXTURE = {"num_times": 20, "h": 540, "w": 960}
HYPERNERF_STEPS = 32
HYPERNERF_IST_FROM = 16
DNERF_FIXTURE = {"num_frames": 4, "h": 400, "w": 400}
DNERF_STEPS = 8
DNERF_RENDER_STEPS = 4
BALL_BOX_MIN = 8                  # px a side of a DynMetric box, at least
SEMANTIC = "semantic-nerfw"
SEMANTIC_CPU_SEEDS = (2,)
NEUS = "neus"
NEUS_FRAMES = ((1,), (), False)  # render_phase's counted, timed, profiled
NEUS_CPU_RAYS = 256
NEUS_CPU_SEEDS = (2,)
NORMALS_TOL = 1e-2                # the rendered normals, card against CPU
NEUS_REL_TOL = 1e-2               # NeuS rgb/accumulation, of their max
SITCOMS_FIXTURE = {"num_cameras": 20, "h": 270, "w": 480}
SEMANTIC_TRAINER_STEPS = 24
NEUS_CLI_STEPS = 16
# cli_neus' ring: a quarter of NERFSTUDIO_FIXTURE's pixels (a NeuS frame
# at 960x540 takes ~36 s), 9 train frames and 1 eval frame
NEUS_FIXTURE = {"num_frames": 10, "h": 270, "w": 480}
NEUS_RENDER_STEPS = 2
# the exporter's arguments beyond --load-config and --output-dir: its
# defaults on the card
# a user's COLMAP capture, and the remaining dataparsers
CAPTURE_FIXTURE = {"num_frames": 20, "h": 270, "w": 480}
CAPTURE_STEPS = 64
CAPTURE_EVAL_IMAGE = 32
PANORAMA = {"h": 512, "w": 1024}
POSE_TOL = 1e-5                   # the parsed ring against the capture's
NGP = "instant-ngp"
PARSER_FIXTURE = {"h": 270, "w": 480}
PARSER_STEPS = 8
EXPORT_ARGS = {"pointcloud": [], "cameras": [], "marching-cubes": [],
               "tsdf": [], "poisson": []}


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


_FLUSH = None


def time_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` calls (CUDA events around
    each call), with the 50 MB L2 cache flushed before each: in a frame,
    a plane's table comes back only after ~0.3 GB of other tables."""
    global _FLUSH
    if _FLUSH is None:
        _FLUSH = torch.empty(256 << 20, dtype=torch.uint8, device=DEVICE)
    fn()
    pairs = []
    for _ in range(iters):
        _FLUSH.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / iters


def all_kernels():
    """Every kernel wrapper of the port (each counts its launches)."""
    from soccernerfs_tpu_torch.ops.kernels import plane_kernels as pk
    from soccernerfs_tpu_torch.ops.kernels import scatter_kernels as sk

    return (*pk.KERNELS, *sk.KERNELS)


def reset_launch_counts() -> None:
    for k in all_kernels():
        k.launches = 0
        if hasattr(k, "launches_by_width"):
            k.launches_by_width = {}


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in all_kernels()}


def method_parts(method):
    """(model module, model config, camera optimizer config) of a method."""
    from soccernerfs_tpu_torch.configs import method_configs as mc
    from soccernerfs_tpu_torch.models import get_model

    return (get_model(mc.model_names[method]), mc.model_configs[method],
            mc.camera_optimizer_configs[method])


# the per-plane forward kernels: the train forward's; a pure render
# launches none of them (its planes go through kplanes_fwd_fused)
FORWARD = ("bilerp_fwd_unpacked", "bilerp_fwd_packed")
XZ_YZ = ([(0, 1), (1, 3)], 2)              # [(c1, plane index)], c2
XT_YT_ZT = ([(0, 2), (1, 4), (2, 5)], 3)
# the plane kernels' other widths (width_kernel_phase): the compiled 16,
# 24 (kp_res_study's) and 48, and 20, which the wrappers pad to 24; on
# [time, space] planes of kp_res_study's finest scale (100 x 64 * 32)
WIDTH_FEATS = (16, 20, 24, 48)
WIDTH_PLANES = (100, 2048)


def kernel_cases(cfg, staged):
    """The render path's plane groups that the kernel phase runs, at the
    path's point counts: the finest scale's space (XZ, YZ) and time groups
    (the unpacked kernel at k-planes width), the next scale's time group
    and the first proposal field's time group (the packed kernel, F = 32
    and F = 8)."""
    chunk = cfg.eval_num_rays_per_chunk
    m_field = chunk * cfg.num_nerf_samples_per_ray
    m_prop = chunk * cfg.num_proposal_samples_per_ray[0]
    field = staged["fields"]
    prop = staged["proposal_networks"]["proposal_0"]
    last = len(field["grids"]) - 1
    cases = [(field, last, XZ_YZ, m_field), (field, last, XT_YT_ZT, m_field),
             (field, last - 1, XT_YT_ZT, m_field), (prop, 0, XT_YT_ZT, m_prop)]
    out = []
    for params, s, (members, c2), m in cases:
        h, w, feat = params["grids"][s][members[0][1]].shape
        table = params["grids_packed"][s][members[0][1]]
        kind = "unpacked" if table.shape[-1] == feat else "packed"
        label = f"{'field' if params is field else 'proposal0'} scale {s} " \
                f"{len(members)} planes [{h},{w},{feat}] table {list(table.shape)}"
        out.append((label, kind, params, s, h, w, members, c2, m))
    return out


def group_bytes(m, feat, tables) -> int:
    """Least bytes one launch moves: the shared ty (4 B per point); row
    id, tx (8 B) and f32 features out (4F B) per point and plane; each
    table read once."""
    return (m * 4 + len(tables) * m * (8 + 4 * feat)
            + sum(t.numel() * t.element_size() for t in tables))


def fwd_case(tag, label, kern, plain, library, lib_outs, bytes_, flops, **extra):
    """Check one forward case against its plain version (KERNEL_REL_TOL of
    the max; bit-equal expected) and time kernel (20 calls), plain version
    (5) and library yardstick (10); ``lib_outs`` turns the library's
    output into the kernel's outputs (a list of [M, F]).  Logs and
    returns its row."""
    got = [t.clone() for t in _as_list(kern())]
    want = [t.clone() for t in _as_list(plain())]
    torch.cuda.synchronize()
    err = max(float((g - e).abs().max()) for g, e in zip(got, want))
    scale = max(float(e.abs().max()) for e in want)
    if not err <= KERNEL_REL_TOL * scale:
        raise AssertionError(f"{tag} {label}: max |kernel - plain| = "
                             f"{err} > {KERNEL_REL_TOL} * {scale}")
    lib_err = max(float((g - e).abs().max())
                  for g, e in zip(got, lib_outs(library())))
    del got, want
    ms = time_ms(kern, 20)
    plain_ms = time_ms(plain, 5)
    library_ms = time_ms(library, 10)
    t_bytes = bytes_ / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_F32_FLOPS * 1e3
    row = {
        "case": label, **extra, "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "library_max_abs_diff": lib_err, "bytes": bytes_, "flops": flops,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
    }
    log("kernel", tag, json.dumps(row))
    return row


def _as_list(out):
    return list(out) if isinstance(out, (list, tuple)) else [out]


def group_sampler(planes, pts, members, c2):
    """The per-plane route's operands of one plane group: a y cell and
    fraction shared by the group, a row id and x fraction per plane; and
    the grid_sample yardstick over the same bf16 plane values as f32 NCHW
    at the same continuous coordinates.  Returns (rowids, txs, ty,
    grid, library)."""
    from soccernerfs_tpu_torch.ops.grid_sample import grid_coords

    h, w = planes[0].shape[:2]
    yc, ty = grid_coords(pts[:, c2], h)
    rowids, txs = [], []
    for c1, _ci in members:
        xc, tx = grid_coords(pts[:, c1], w)
        rowids.append(yc * w + xc)
        txs.append(tx)
    inp = torch.stack([p.to(torch.bfloat16).float().permute(2, 0, 1)
                       for p in planes])
    grid = torch.stack([pts[:, [c1, c2]] for c1, _ci in members])[:, None]

    def library():
        return torch.nn.functional.grid_sample(
            inp, grid, mode="bilinear", padding_mode="border",
            align_corners=True)

    return rowids, txs, ty, grid, library


def per_plane(lib):
    """grid_sample's [P, F, 1, M] output as P [M, F]."""
    return list(lib[:, :, 0].permute(0, 2, 1))


def kernel_phase(cfg, staged, dev):
    from soccernerfs_tpu_torch.ops.kernels import plane_kernels as pk

    gen = torch.Generator(device=dev).manual_seed(SEED)
    results = {"bilerp_fwd_unpacked": [], "bilerp_fwd_packed": []}
    for label, kind, params, s, h, w, members, c2, m in kernel_cases(cfg, staged):
        pts = torch.rand((m, 4), generator=gen, device=dev) * 2.0 - 1.0
        tables = [params["grids_packed"][s][ci] for _c1, ci in members]
        planes = [params["grids"][s][ci] for _c1, ci in members]
        rowids, txs, ty, _grid, library = group_sampler(planes, pts, members, c2)
        feat = planes[0].shape[-1]
        if kind == "unpacked":
            def kern():
                return pk.bilerp_fwd_unpacked(tables, rowids, txs, ty, h=h, w=w)

            def plain():
                return pk.bilerp_fwd_unpacked_plain(tables, rowids, txs, ty,
                                                    h=h, w=w)
        else:
            def kern():
                return pk.bilerp_fwd_packed(tables, rowids, txs, ty)

            def plain():
                return pk.bilerp_fwd_packed_plain(tables, rowids, txs, ty)

        n = len(members)
        results[f"bilerp_fwd_{kind}"].append(fwd_case(
            kind, label, kern, plain, library, per_plane,
            group_bytes(m, feat, tables),
            m * (1 + n * (9 * feat + 1)),   # 1-ty; 1-tx and 9 per feature
            planes=n, M=m))
        del pts, rowids, txs, ty, library
        torch.cuda.empty_cache()
    return results


def width_kernel_phase(cfg, dev):
    """The five plane kernels at the widths of WIDTH_FEATS (each compiled
    width but 8 and 32, which the phases above hold, and one the wrappers
    pad), on the time group (XT, YT, ZT) of kp_res_study's finest scale
    (WIDTH_PLANES, random bf16 values) at the render path's field point
    count, uniform random points: each against its plain version
    (forward KERNEL_REL_TOL, bit-equal expected; backward 1e-5 of the max,
    as bwd_case holds it), timed beside its library call (F.grid_sample,
    for the fused kernel with the product; aten.grid_sampler_2d_backward)
    and its byte bound at F.  The per-plane forward wrappers take [h*w, F]
    and [h*w, 4F] tables (a padded width is padded per call, inside the
    timed call); the fused kernel the tables stage_table stages (padded
    once).  Returns the rows by kernel, "order": "width"."""
    from soccernerfs_tpu_torch.ops.grid_sample import quad_pack, stage_table
    from soccernerfs_tpu_torch.ops.kernels import plane_kernels as pk

    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    m = cfg.eval_num_rays_per_chunk * cfg.num_nerf_samples_per_ray
    h, w = WIDTH_PLANES
    members, c2 = XT_YT_ZT
    descs = [(c1, c2, h, w) for c1, _ci in members]
    n = len(members)
    strip = bwd_strip()
    results = {k.__name__: [] for k in pk.KERNELS}
    for feat in WIDTH_FEATS:
        planes = [0.1 + 0.4 * torch.rand((h, w, feat), generator=gen, device=dev)
                  for _ in members]
        pts = torch.rand((m, 4), generator=gen, device=dev) * 2.0 - 1.0
        rowids, txs, ty, grid, library = group_sampler(planes, pts, members, c2)
        label = (f"F = {feat} (kernel width {pk.native_feat(feat)}), {n} planes "
                 f"[{h},{w},{feat}], random points")
        extra = {"order": "width", "feat": feat, "planes": n, "M": m}
        unpacked = [p.reshape(h * w, feat).to(torch.bfloat16).contiguous()
                    for p in planes]
        packed = [quad_pack(p.to(torch.bfloat16)).contiguous() for p in planes]
        flops = m * (1 + n * (9 * feat + 1))
        results["bilerp_fwd_unpacked"].append(fwd_case(
            "unpacked", label,
            lambda: pk.bilerp_fwd_unpacked(unpacked, rowids, txs, ty, h=h, w=w),
            lambda: pk.bilerp_fwd_unpacked_plain(unpacked, rowids, txs, ty,
                                                 h=h, w=w),
            library, per_plane, group_bytes(m, feat, unpacked), flops, **extra))
        results["bilerp_fwd_packed"].append(fwd_case(
            "packed", label,
            lambda: pk.bilerp_fwd_packed(packed, rowids, txs, ty),
            lambda: pk.bilerp_fwd_packed_plain(packed, rowids, txs, ty),
            library, per_plane, group_bytes(m, feat, packed), flops, **extra))
        del unpacked, packed
        staged = [stage_table(p) for p in planes]
        out = torch.empty((m, feat), device=dev)

        def product(lib):
            acc = lib[0, :, 0].clone()
            for k in range(1, n):
                acc.mul_(lib[k, :, 0])
            return [acc.t()]

        # coordinates read, features written at F; the tables at F, once
        table_bytes = sum(p.numel() * 2 * 4 for p in planes)
        results["kplanes_fwd_fused"].append(fwd_case(
            "fused", label,
            lambda: pk.kplanes_fwd_fused(pts, staged, descs, out),
            lambda: pk.kplanes_fwd_fused_plain(pts, staged, descs, out),
            library, product, m * 4 * 4 + m * feat * 4 + table_bytes,
            m * n * (16 + 10 * feat), **extra))
        del staged, out
        gs = [torch.randn((m, feat), generator=gen, device=dev) for _ in members]
        for kind in ("unpacked", "packed"):
            case = {"label": label, "order": "width", "kind": kind, "h": h,
                    "w": w, "gs": gs, "rowids": rowids, "txs": txs, "ty": ty,
                    "grid": grid}
            results[f"bilerp_bwd_{kind}"].append(bwd_case(case, strip))
        del planes, pts, rowids, txs, ty, grid, library, gs
        torch.cuda.empty_cache()
    for name, rows in results.items():
        log(f"widths {name}: " + "; ".join(
            f"F = {r['feat']} {r['ms']:.4f} ms (bound {r['bound_ms']:.4f}, "
            f"plain {r['plain_ms']:.3f}, library {r['library_ms']:.3f}, "
            f"err {r['max_abs_err']:.3e})" for r in rows))
    return results


def capture_fused_launches(method, params, cams, dev, aabb, fields) -> list:
    """The fused launches of chunk 0 of camera 0's frame, where
    interpolate_kplanes hands them to the kernel: the render path's own
    points, captured at ``pk._launch_fused`` during one frame of
    ``render_camera`` (every launch runs as usual).  ``fields`` names the
    fields to capture, {label: (F, M, scales)}, told apart by feature
    width and point count; the chunk's first ``scales`` launches of each.
    Returns [(label, scale, pts, tables, planes, out's row stride, out's
    column offset)]."""
    from soccernerfs_tpu_torch.configs.method_configs import model_names
    from soccernerfs_tpu_torch.engine.render import render_camera
    from soccernerfs_tpu_torch.ops.kernels import plane_kernels as pk

    _module, cfg, _camera_optimizer = method_parts(method)
    launch = pk._launch_fused
    captured, seen = [], {}

    def capture(pts, tables, planes, out):
        for label, (feat, m, scales) in fields.items():
            if (out.shape[1], pts.shape[0]) == (feat, m):
                scale = seen.get(label, 0)
                seen[label] = scale + 1
                if scale < scales:
                    captured.append((label, scale, pts.clone(), list(tables),
                                     list(planes), out.stride(0),
                                     out.storage_offset() % out.stride(0)))
        return launch(pts, tables, planes, out)

    pk._launch_fused = capture
    try:
        render_camera(cfg, params, cams, 0, device=dev, aabb=aabb,
                      model=model_names[method])
    finally:
        pk._launch_fused = launch
    torch.cuda.synchronize()
    return captured


def unstaged_planes(tables, planes, feat):
    """The bf16 plane values of staged tables as f32 [F, h, w] (a packed
    row's first quarter is the plane's own cell)."""
    return [t[:, :feat].reshape(h, w, feat).float().permute(2, 0, 1).contiguous()
            for t, (_c1, _c2, h, w) in zip(tables, planes)]


def fused_kernel_phase(cfg, staged, cams, dev, aabb):
    """kplanes_fwd_fused on the render path's own operands: chunk 0 of
    camera 0's frame, captured for the main field's scales and proposal_0
    (capture_fused_launches), each launch against its plain version
    (KERNEL_REL_TOL; bit-equal expected) and timed (CUDA events, L2
    flushed) beside the route it replaced on the render path (grid_coords
    per axis, bilerp_fwd_unpacked / _packed per plane group, the in-place
    product in group order, the column copy) and the library yardstick
    (F.grid_sample per shape group of f32 planes, the product in the
    planes' order, the column copy), into a fresh [M, S*F] buffer at the
    launch's column.  Bound: bytes, the coordinates read and the F f32
    features written once, and the table rows the points touch
    (``touched_table_bytes``)."""
    from soccernerfs_tpu_torch.ops.grid_sample import grid_coords
    from soccernerfs_tpu_torch.ops.kernels import plane_kernels as pk

    chunk = cfg.eval_num_rays_per_chunk
    field = staged["fields"]
    prop = staged["proposal_networks"]["proposal_0"]
    fields = {
        "field": (field["grids"][0][0].shape[-1],
                  chunk * cfg.num_nerf_samples_per_ray, len(field["grids"])),
        "proposal0": (prop["grids"][0][0].shape[-1],
                      chunk * cfg.num_proposal_samples_per_ray[0], 1),
    }
    rows = []
    for label, s, pts, tables, planes, stride, col in capture_fused_launches(
            MODEL, staged, cams, dev, aabb, fields):
        m, dim = pts.shape
        feat = fields[label][0]
        buf = torch.empty((m, stride), device=dev)
        out = buf[:, col:col + feat]
        kinds = ["unpacked" if t.shape[1] == feat else "packed" for t in tables]

        def kern():
            return pk.kplanes_fwd_fused(pts, tables, planes, out)

        def plain():
            return pk.kplanes_fwd_fused_plain(pts, tables, planes, out)

        groups = {}
        for i, (_c1, c2, _h, w) in enumerate(planes):
            groups.setdefault((c2, w), []).append(i)

        def old_route():
            acc = None
            for (c2, w), members in groups.items():
                h = planes[members[0]][2]
                yc, ty = grid_coords(pts[:, c2], h)
                rowids, txs = [], []
                for i in members:
                    xc, tx = grid_coords(pts[:, planes[i][0]], w)
                    rowids.append(yc * w + xc)
                    txs.append(tx)
                group = [tables[i] for i in members]
                if kinds[members[0]] == "unpacked":
                    feats = pk.bilerp_fwd_unpacked(group, rowids, txs, ty, h=h, w=w)
                else:
                    feats = pk.bilerp_fwd_packed(group, rowids, txs, ty)
                for f in feats:
                    acc = f if acc is None else acc.mul_(f)
            return out.copy_(acc)

        shapes = {}
        for i, (_c1, _c2, h, w) in enumerate(planes):
            shapes.setdefault((h, w), []).append(i)
        inputs = {key: torch.stack(unstaged_planes([tables[i] for i in idx],
                                                   [planes[i] for i in idx], feat))
                  for key, idx in shapes.items()}

        def library():
            per_plane = [None] * len(planes)
            for key, idx in shapes.items():
                grid = torch.stack([pts[:, [planes[i][0], planes[i][1]]]
                                    for i in idx])[:, None]
                res = torch.nn.functional.grid_sample(
                    inputs[key], grid, mode="bilinear", padding_mode="border",
                    align_corners=True)
                for j, i in enumerate(idx):
                    per_plane[i] = res[j, :, 0]
            acc = per_plane[0].clone()
            for f in per_plane[1:]:
                acc.mul_(f)
            return out.copy_(acc.t())

        got = kern().clone()
        want = plain().clone()
        old = old_route().clone()
        lib = library().clone()
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        if not err <= KERNEL_REL_TOL * scale:
            raise AssertionError(f"kplanes_fwd_fused {label} scale {s}: max "
                                 f"|kernel - plain| = {err} > {KERNEL_REL_TOL}"
                                 f" * {scale}")
        old_err = float((old - want).abs().max())
        lib_err = float((lib - want).abs().max())
        del got, want, old, lib

        ms = time_ms(kern, 20)
        plain_ms = time_ms(plain, 3)
        old_ms = time_ms(old_route, 10)
        library_ms = time_ms(library, 5)
        touched = 0
        for table, (c1, c2, h, w), kind in zip(tables, planes, kinds):
            xc, _tx = grid_coords(pts[:, c1], w)
            yc, _ty = grid_coords(pts[:, c2], h)
            touched += touched_table_bytes(
                kind, [table], [yc * w + xc],
                (h, w) if kind == "unpacked" else (table.shape[0],))
        whole = sum(t.numel() * t.element_size() for t in tables)
        bytes_ = m * dim * 4 + m * feat * 4 + touched
        # per point and plane: 7 operations a coordinate, 2 one-minus, 9 a
        # feature to lerp, 1 to multiply
        flops = m * len(planes) * (16 + 10 * feat)
        t_bytes = bytes_ / H100_BYTES_PER_S * 1e3
        t_ops = flops / H100_F32_FLOPS * 1e3
        row = {
            "case": f"{label} scale {s}, chunk 0 of camera 0, {len(planes)} "
                    f"planes {[list(p) for p in planes]}, tables {kinds}, "
                    f"column {col} of {stride}",
            "order": "frame", "planes": len(planes), "M": m, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "old_route_ms": old_ms,
            "old_route_max_abs_diff": old_err, "library_ms": library_ms,
            "library_max_abs_diff": lib_err, "bytes": bytes_,
            "whole_table_bytes": whole, "flops": flops,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        }
        log("kernel fused", json.dumps(row))
        rows.append(row)
        del pts, tables, buf, out, inputs
        torch.cuda.empty_cache()
    want = {"proposal0 scale 0",
            *[f"field scale {s}" for s in range(fields["field"][2])]}
    if sorted(r["case"].split(",")[0] for r in rows) != sorted(want):
        raise AssertionError(f"captured fused launches: {[r['case'] for r in rows]}")
    return {"kplanes_fwd_fused": rows}


def bwd_kernel_cases(cfg, params):
    """The train step's plane groups that the backward kernel phase runs,
    at its point counts (4096 rays): the finest scale's space and time
    groups and the coarsest scale's space group (4096 rows, the contention
    case) of the main field (bilerp_bwd_unpacked), the first proposal
    field's time group and the second's space group (bilerp_bwd_packed,
    F = 8)."""
    from soccernerfs_tpu_torch.configs.method_configs import train_num_rays_per_batch

    rays = train_num_rays_per_batch[MODEL]
    field = params["fields"]["grids"]
    props = params["proposal_networks"]
    last = len(field) - 1
    m_field = rays * cfg.num_nerf_samples_per_ray
    return [
        (f"field scale {last}", "unpacked", field[last], XZ_YZ, m_field),
        (f"field scale {last}", "unpacked", field[last], XT_YT_ZT, m_field),
        ("field scale 0", "unpacked", field[0], XZ_YZ, m_field),
        ("proposal0", "packed", props["proposal_0"]["grids"][0], XT_YT_ZT,
         rays * cfg.num_proposal_samples_per_ray[0]),
        ("proposal1", "packed", props["proposal_1"]["grids"][0], XZ_YZ,
         rays * cfg.num_proposal_samples_per_ray[1]),
    ]


def bwd_random_cases(cfg, params, dev):
    """bwd_kernel_cases' groups with uniform random points and gradients:
    one backward case each (see bwd_case)."""
    from soccernerfs_tpu_torch.ops.grid_sample import grid_coords

    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    for label, kind, grids, (members, c2), m in bwd_kernel_cases(cfg, params):
        h, w, feat = grids[members[0][1]].shape
        pts = torch.rand((m, 4), generator=gen, device=dev) * 2.0 - 1.0
        gs = [torch.randn((m, feat), generator=gen, device=dev) for _ in members]
        yc, ty = grid_coords(pts[:, c2], h)
        rowids, txs = [], []
        for c1, _ci in members:
            xc, tx = grid_coords(pts[:, c1], w)
            rowids.append(yc * w + xc)
            txs.append(tx)
        yield {"label": f"{label}, random points", "order": "random",
               "kind": kind, "h": h, "w": w, "gs": gs, "rowids": rowids,
               "txs": txs, "ty": ty,
               "grid": torch.stack([pts[:, [c1, c2]] for c1, _ci in members])[:, None]}


def make_trainer(method, tree, dev, aux=None):
    """(TrainStep, its state) of a method as registered, on bench.py's
    ring, the parameters loaded from ``tree``; the model's state ``aux``
    (moved to ``dev``) when given, else its ``init_aux``."""
    from soccernerfs_tpu_torch.configs.method_configs import (
        model_names, optimizer_configs)
    from soccernerfs_tpu_torch.convert import params_from_jax
    from soccernerfs_tpu_torch.engine.trainer import TrainStep

    _module, cfg, camera_optimizer = method_parts(method)
    trainer = TrainStep(cfg, ring_cameras(dev), AABB, optimizer_configs[method],
                        device=dev, model=model_names[method],
                        camera_optimizer=camera_optimizer)
    if aux is not None:
        aux = {k: v.to(dev) for k, v in aux.items()}
    return trainer, trainer.init_state(params_from_jax(tree, device=dev), aux)


def touched_table_bytes(name, tables, rowids, shape) -> int:
    """Bytes of the table rows one forward plane launch needs: every
    distinct row its points touch (the four corner rows of an unpacked
    [h*w, F] table, the one quad-packed row of a packed table), read once."""
    from soccernerfs_tpu_torch.ops.kernels import plane_kernels as pk

    total = 0
    for table, rowid in zip(tables, rowids):
        if name.endswith("unpacked"):
            rows = torch.cat(pk.corner_rows(rowid, h=shape[0], w=shape[1]))
        else:
            rows = torch.clamp(rowid.long(), 0, shape[0] - 1)
        total += (int(torch.unique(rows).numel()) * table.shape[1]
                  * table.element_size())
    return total


def fwd_step_bounds(tree, dev) -> dict:
    """The forward plane launches of one K-Planes train step (step 0 of the
    train phase: make_batch(0), the same draws), captured where the
    wrappers launch: per kernel, (launches, their summed byte bound in ms,
    the same with whole tables in ms).  A launch's bound: its points'
    inputs and outputs (``group_bytes`` less the tables) and the table rows
    its points touch (``touched_table_bytes``: a step's 4096 rays touch a
    fraction of the finest planes), at the card's memory rate."""
    from soccernerfs_tpu_torch.configs.method_configs import train_num_rays_per_batch
    from soccernerfs_tpu_torch.ops.kernels import plane_kernels as pk

    trainer, state = make_trainer(MODEL, tree, dev)
    launch = pk._launch
    bounds = {"bilerp_fwd_unpacked": [0, 0.0, 0.0],
              "bilerp_fwd_packed": [0, 0.0, 0.0]}

    def capture(name, ins, rowids, txs, ty, outs, m, feat, *shape):
        if name.startswith("snt_bilerp_fwd_"):
            entry = bounds[name[len("snt_"):]]
            whole = group_bytes(m, feat, ins)
            tables = sum(t.numel() * t.element_size() for t in ins)
            touched = touched_table_bytes(name, ins, rowids, shape)
            entry[0] += 1
            entry[1] += (whole - tables + touched) / H100_BYTES_PER_S * 1e3
            entry[2] += whole / H100_BYTES_PER_S * 1e3
        return launch(name, ins, rowids, txs, ty, outs, m, feat, *shape)

    pk._launch = capture
    try:
        trainer.loss_and_grads(
            state, make_batch(0, train_num_rays_per_batch[MODEL], dev),
            train_proposal_networks=True,
            generator=torch.Generator(device=dev).manual_seed(SEED))
    finally:
        pk._launch = launch
    del trainer, state
    torch.cuda.empty_cache()
    return {k: tuple(v) for k, v in bounds.items()}


def bwd_step_cases(tree, dev):
    """The backward plane launches of one K-Planes train step (step 0 of
    the train phase: an update step, make_batch(0), the same draws),
    captured where the wrappers launch, one backward case each (see
    bwd_case): the path's own operands, its samples flattened ray by ray."""
    from soccernerfs_tpu_torch.configs.method_configs import train_num_rays_per_batch
    from soccernerfs_tpu_torch.ops.kernels import plane_kernels as pk

    trainer, state = make_trainer(MODEL, tree, dev)
    launch = pk._launch
    record = []

    def capture(name, ins, rowids, txs, ty, outs, m, feat, *shape):
        if name.startswith("snt_bilerp_bwd_"):
            record.append((name[len("snt_bilerp_bwd_"):],
                           [t.clone() for t in ins], [t.clone() for t in rowids],
                           [t.clone() for t in txs], ty.clone(), shape))
        return launch(name, ins, rowids, txs, ty, outs, m, feat, *shape)

    pk._launch = capture
    try:
        trainer.loss_and_grads(
            state, make_batch(0, train_num_rays_per_batch[MODEL], dev),
            train_proposal_networks=True,
            generator=torch.Generator(device=dev).manual_seed(SEED))
    finally:
        pk._launch = launch
    # a packed launch names its rows only: the proposal planes give (h, w)
    hw = {g.shape[0] * g.shape[1]: tuple(g.shape[:2])
          for field in state.params["proposal_networks"].values()
          for scale in field["grids"] for g in scale}
    del trainer, state
    for j, (kind, gs, rowids, txs, ty, shape) in enumerate(record):
        h, w = shape if kind == "unpacked" else hw[shape[0]]
        # the continuous coordinates of each cell and fraction, for the
        # grid_sample yardstick
        yc = torch.div(rowids[0], w, rounding_mode="floor")
        y = (yc + ty) * (2.0 / max(h - 1, 1)) - 1.0
        grid = torch.stack([torch.stack(
            [(r - yc + tx) * (2.0 / max(w - 1, 1)) - 1.0, y], -1)
            for r, tx in zip(rowids, txs)])[:, None]
        yield {"label": f"train step launch {j}, ray-ordered", "order": "ray",
               "kind": kind, "h": h, "w": w, "gs": gs,
               "rowids": rowids, "txs": txs, "ty": ty, "grid": grid}


def bwd_strip() -> int:
    """Points per lane strip of the built backward kernels."""
    from soccernerfs_tpu_torch.ops.kernels import build

    return build.load("plane_bwd_kernels").snt_bilerp_bwd_strip()


def strip_flushes(rowid, strip) -> int:
    """Corner-sum flushes of one plane's points walked in strips of
    ``strip``: a strip's first point and each point whose row id differs
    from the one before it."""
    change = torch.ones_like(rowid, dtype=torch.bool)
    change[1:] = rowid[1:] != rowid[:-1]
    change[::strip] = True
    return int(change.sum())


def bwd_case(case, strip):
    """Check one backward case against its plain version and time kernel,
    plain version and aten.grid_sampler_2d_backward; returns its row."""
    from soccernerfs_tpu_torch.ops.kernels import plane_kernels as pk

    kind, h, w, gs = case["kind"], case["h"], case["w"], case["gs"]
    m, feat, n = gs[0].shape[0], gs[0].shape[1], len(gs)
    args = (gs, case["rowids"], case["txs"], case["ty"])
    if kind == "unpacked":
        def kern():
            return pk.bilerp_bwd_unpacked(*args, h=h, w=w)

        def plain():
            return pk.bilerp_bwd_unpacked_plain(*args, h=h, w=w)
    else:
        def kern():
            return pk.bilerp_bwd_packed(*args, rows=h * w)

        def plain():
            return pk.bilerp_bwd_packed_plain(*args, rows=h * w)

    got = kern()
    want = plain()
    torch.cuda.synchronize()
    err = max(float((g - e).abs().max()) for g, e in zip(got, want))
    scale = max(float(e.abs().max()) for e in want)
    # register sums and atomics add in another order, which changes from
    # run to run
    if not err <= KERNEL_REL_TOL * scale:
        raise AssertionError(f"bwd {kind} {case['label']}: max |kernel - plain| "
                             f"= {err} > {KERNEL_REL_TOL} * {scale}")
    del got, want

    # yardstick: the input gradient of grid_sample (bilinear, border,
    # align_corners) of f32 NCHW planes of the same shape, for the same
    # points and gradients (the planes' values do not enter it)
    inp = torch.zeros((n, feat, h, w), device=gs[0].device)
    gout = torch.stack(gs).permute(0, 2, 1)[:, :, None].contiguous()

    def library():
        return torch.ops.aten.grid_sampler_2d_backward(
            gout, inp, case["grid"], 0, 1, True, [True, False])[0]

    lib_diff = None
    if kind == "unpacked":
        lib = library().permute(0, 2, 3, 1).reshape(n, h * w, feat)
        lib_diff = max(float((g - e).abs().max()) for g, e in zip(kern(), lib))
        del lib

    # the kernel's time: the median of BWD_PASSES passes of 20 launches
    # each, every pass beside it (a pass's mean can carry a transient)
    passes = [time_ms(kern, 20) for _ in range(BWD_PASSES)]
    ms = statistics.median(passes)
    plain_ms = time_ms(plain, 5)
    library_ms = time_ms(library, 10)
    table = h * w * feat * (1 if kind == "unpacked" else 4)
    bytes_ = m * 4 + n * m * (8 + 4 * feat) + n * table * 4
    flops = m * (1 + n * (5 + 8 * feat))   # 1-ty; 1-tx, 4 weights, 8/feature
    t_bytes = bytes_ / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_F32_FLOPS * 1e3
    # the kernel's atomic operations: per flush F lanes (4 corners x F/4
    # quarters), one 16-byte vector reduction each
    flushes = sum(strip_flushes(r, strip) for r in case["rowids"])
    reductions = flushes * feat
    row = {
        "case": f"{case['label']}, {n} planes [{h},{w},{feat}] "
                f"grad table {[h * w, table // (h * w)]}",
        "order": case["order"], "feat": feat, "planes": n, "M": m,
        "max_abs_err": err, "max_abs_plain": scale, "ms": ms,
        "ms_passes": passes, "plain_ms": plain_ms,
        "library_ms": library_ms, "library_max_abs_diff": lib_diff,
        "bytes": bytes_, "flops": flops, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "strip": strip, "points_per_flush": n * m / flushes,
        "vector_reductions": reductions,
        "G_reductions_per_s": reductions / ms / 1e6,
        "G_float_adds_per_s": n * m * 4 * feat / ms / 1e6,
    }
    log("kernel", f"bwd_{kind}", json.dumps(row))
    return row


def bwd_kernel_phase(cfg, params, tree, dev):
    """Both backward kernels on bwd_kernel_cases' random points, then on
    the launches of one train step (bwd_step_cases); returns the rows by
    kernel."""
    strip = bwd_strip()
    results = {"bilerp_bwd_unpacked": [], "bilerp_bwd_packed": []}
    for cases in (bwd_random_cases(cfg, params, dev), bwd_step_cases(tree, dev)):
        for case in cases:
            results[f"bilerp_bwd_{case['kind']}"].append(bwd_case(case, strip))
        torch.cuda.empty_cache()
    for name, rows in results.items():
        ray = [r for r in rows if r["order"] == "ray"]
        log(f"train step launches of {name}, ray-ordered: {len(ray)}, kernel "
            f"{sum(r['ms'] for r in ray):.4f} ms, plain "
            f"{sum(r['plain_ms'] for r in ray):.4f} ms, library "
            f"{sum(r['library_ms'] for r in ray):.4f} ms, bound "
            f"{sum(r['bound_ms'] for r in ray):.4f} ms (bytes), "
            f"{sum(r['vector_reductions'] for r in ray)} vector reductions")
    return results


def scatter_layout(dev) -> dict:
    """The built scatter kernel's strip per row width and threads per block,
    and the card's SM count: scatter_plan's arguments."""
    from soccernerfs_tpu_torch.ops.kernels import build
    from soccernerfs_tpu_torch.ops.kernels.scatter_kernels import CHANNELS

    lib = build.load("scatter_kernels")
    return {"strip": {c: lib.snt_scatter_add_rows_strip(c) for c in CHANNELS},
            "threads": lib.snt_scatter_add_rows_threads(),
            "sms": torch.cuda.get_device_properties(dev).multi_processor_count}


def expand_updates(g, idxs, ws):
    """The update stream sorted_scatter_add takes: [G*K*B, c] updates and
    their rows."""
    groups, corners, points = idxs.shape
    upd = g.view(points, groups, 1, -1).permute(1, 2, 0, 3)
    upd = (upd * ws[..., None] if ws is not None
           else upd.expand(groups, corners, points, -1))
    return upd.reshape(groups * corners * points, -1), idxs.reshape(-1)


def scatter_random_cases(cfg, dev):
    """scatter_add_rows at the nerfacto train step's shapes (4096 rays):
    corner rows and weights of uniform random points from the encoder's own
    ``grid_corners``, random gradients; yields (label, (g, idxs, ws,
    rows))."""
    from soccernerfs_tpu_torch.configs.method_configs import train_num_rays_per_batch
    from soccernerfs_tpu_torch.ops.hash_grid import (grid_corners, level_layout,
                                                     strided_levels)

    rays = train_num_rays_per_batch[NERFACTO]
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    main = cfg.field_config().grid
    prop0 = cfg.density_field_configs()[0][1].grid
    b_main = rays * cfg.num_nerf_samples_per_ray
    b_prop = rays * cfg.num_proposal_samples_per_ray[0]

    def grid_case(gcfg, points, level=None):
        """(g, idxs, ws, rows) of a whole grid, or of one of its levels."""
        idxs, ws = grid_corners(gcfg, torch.rand((points, 3), generator=gen,
                                                 device=dev))
        offsets = level_layout(gcfg)[0]
        rows = offsets[-1]
        if level is not None:
            idxs = (idxs[level:level + 1] - offsets[level]).contiguous()
            ws = ws[level:level + 1].contiguous()
            rows = offsets[level + 1] - offsets[level]
        g = torch.randn((points, idxs.shape[0] * gcfg.level_dim), generator=gen,
                        device=dev)
        return g, idxs, ws, rows

    def sorted_stream(g, idxs, ws, rows):
        upd, flat = expand_updates(g, idxs, ws)
        flat, order = torch.sort(flat)
        return upd[order].contiguous(), flat[None, None].contiguous(), None, rows

    hashed_main = strided_levels(main).index(False)
    hashed_prop = strided_levels(prop0).index(False)
    # drawn first, as earlier runs drew them
    wide = (torch.randn((b_main, 8), generator=gen, device=dev),
            torch.randint(0, 1 << 17, (1, 8, b_main), generator=gen, device=dev,
                          dtype=torch.int32),
            torch.rand((1, 8, b_main), generator=gen, device=dev), 1 << 17)
    two_rows = (torch.randn((100_000, 2), generator=gen, device=dev),
                torch.randint(0, 2, (1, 1, 100_000), generator=gen, device=dev,
                              dtype=torch.int32), None, 2)
    yield (f"main grid level {hashed_main} (hashed)",
           grid_case(main, b_main, hashed_main))
    yield (f"main grid level {hashed_main} as sorted_scatter_add takes it "
           f"(expanded, sorted, no weights)",
           sorted_stream(*grid_case(main, b_main, hashed_main)))
    yield "main grid level 0 (dense, contention)", grid_case(main, b_main, 0)
    yield (f"proposal_0 grid level {hashed_prop} (hashed)",
           grid_case(prop0, b_prop, hashed_prop))
    yield ("main grid, all levels (the train path's launch)",
           grid_case(main, b_main))
    yield ("proposal_0 grid, all levels (the train path's launch)",
           grid_case(prop0, b_prop))
    yield "one level, c = 8", wide
    yield "2-row table, 100,000 updates (contention)", two_rows


def scatter_rows(gcfg) -> int:
    """Rows of the table that scatter_add_rows fills for a hash grid: the
    grid's rows, or for a temporal grid its flattened [rows * C_row, 1]."""
    from soccernerfs_tpu_torch.ops.hash_grid import level_layout

    rows = level_layout(gcfg)[0][-1]
    return rows * gcfg.row_channels if gcfg.temporal_dim else rows


def field_grids(cfg) -> dict:
    """{label: grid config} of a model's main field: its one grid ("main"),
    or the decomposition field's stationary grid ("static", read twice: at
    the points and at the deformed points) and its newness and
    decomposition grids ("temporal", alike in shape)."""
    fcfg = cfg.field_config()
    if hasattr(fcfg, "static_grid"):
        return {"static": fcfg.static_grid, "temporal": fcfg.temporal_grid}
    return {"main": fcfg.grid}


def field_samples(cfg) -> int:
    """Samples per ray of a model's main field."""
    return getattr(cfg, "num_nerf_samples_per_ray", None) or cfg.max_num_samples_per_ray


def scatter_step_cases(method, cfg, tree, dev, aux=None):
    """The scatter_add_rows launches of one train step of a hash-grid method
    (step 0 of the train phase: an update step, make_batch(0), the same
    draws, the phase's starting state ``aux``), captured where the wrapper
    launches: the path's own operands, samples flattened ray by ray.
    Yields (label, grid, (g, idxs, ws, rows)); the grid ("main", "static",
    "temporal", "proposal_0", ...; field_grids) is told by its rows and
    points."""
    from soccernerfs_tpu_torch.configs.method_configs import train_num_rays_per_batch
    from soccernerfs_tpu_torch.ops.kernels import scatter_kernels as sk

    trainer, state = make_trainer(method, tree, dev, aux)
    launch = sk._launch
    record = []

    def capture(g, idxs, ws, out, flag, points, groups, corners, c, rows, window):
        record.append((g.clone(), idxs.clone(),
                       None if ws is None else ws.clone(), rows))
        return launch(g, idxs, ws, out, flag, points, groups, corners, c, rows,
                      window)

    sk._launch = capture
    try:
        trainer.loss_and_grads(
            state, method_batch(0, train_num_rays_per_batch[method], dev,
                                method),
            train_proposal_networks=True,
            generator=torch.Generator(device=dev).manual_seed(SEED))
    finally:
        sk._launch = launch
    sk.raise_if_out_of_range(dev)
    del trainer, state
    rays = train_num_rays_per_batch[method]
    grids = {(scatter_rows(d.grid),
              rays * cfg.num_proposal_samples_per_ray[i]): f"proposal_{i}"
             for i, (_idx, d) in enumerate(cfg.density_field_configs())
             } if hasattr(cfg, "density_field_configs") else {}
    for name, gcfg in field_grids(cfg).items():
        grids[(scatter_rows(gcfg), rays * field_samples(cfg))] = name
    while record:
        g, idxs, ws, rows = record.pop(0)
        grid = grids[(rows, g.shape[0])]
        yield (f"{method} train step launch, {grid} grid, ray-ordered", grid,
               (g, idxs, ws, rows))


def scatter_case(label, operands, layout, dev):
    """Check one scatter case against its plain version and time kernel,
    plain version and index_add_; count the kernel's atomic operations
    (scatter_plan); returns its row."""
    from soccernerfs_tpu_torch.ops.kernels import scatter_kernels as sk

    g, idxs, ws, rows = operands
    groups, corners, points = idxs.shape
    c = g.shape[1] // groups

    def kern():
        return sk.scatter_add_rows(g, idxs, ws, rows=rows)

    def plain():
        return sk.scatter_add_rows_plain(g, idxs, ws, rows=rows)

    got, want = kern(), plain()
    mass = float(sk.scatter_add_rows_plain(
        g.abs(), idxs, None if ws is None else ws.abs(), rows=rows).max())

    # yardstick: index_add_ of the update stream, expanded beforehand
    upd, flat = expand_updates(g, idxs, ws)
    upd, flat = upd.contiguous(), flat.long()

    def library():
        return torch.zeros((rows, c), device=dev).index_add_(0, flat, upd)

    library_err = float((library() - want).abs().max())
    torch.cuda.synchronize()
    sk.raise_if_out_of_range(dev)
    err = float((got - want).abs().max())
    # atomics add in an order that changes from run to run, and a row's
    # signed terms cancel: the error scales with the sum of |terms|.  The
    # first level of a proposal grid takes up to ~37,000 updates a row,
    # where f32 sums in the card's orders stray near 1e-6 of that sum, so
    # the kernel may also stray as far as index_add_'s f32 sum of the same
    # updates does in this call.  A lost or misrouted update moves a row
    # by a whole term, far beyond either.
    limit = max(SCATTER_MASS_TOL * mass, library_err)
    if not err <= limit:
        raise AssertionError(f"scatter {label}: max |kernel - plain| = "
                             f"{err} > max({SCATTER_MASS_TOL} * {mass}, "
                             f"index_add_'s {library_err})")
    scale = float(want.abs().max())
    del got, want

    # the kernel's time: the median of BWD_PASSES passes of 20 launches
    passes = [time_ms(kern, 20) for _ in range(BWD_PASSES)]
    ms = statistics.median(passes)
    plain_ms = time_ms(plain, 5)
    library_ms = time_ms(library, 10)
    sk.raise_if_out_of_range(dev)
    del upd, flat
    updates = groups * corners * points
    # g read once, 4 B of index (and 4 B of weight) per update, the
    # table written once: the zero fill is that write
    bytes_ = (g.numel() * 4 + updates * (4 if ws is None else 8)
              + rows * c * 4)
    flops = updates * c * (1 if ws is None else 2)
    t_bytes = bytes_ / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_F32_FLOPS * 1e3
    plan = sk.scatter_plan(idxs, c, rows, strip=layout["strip"][c],
                           threads=layout["threads"], sms=layout["sms"])
    return {
        "case": f"{label}: G {groups}, K {corners}, B {points}, c {c}, "
                f"{rows} rows", "updates": updates, "max_abs_err": err,
        "max_abs_plain": scale, "max_row_mass": mass,
        "library_max_abs_err": library_err,
        "ms": ms, "ms_passes": passes, "plain_ms": plain_ms,
        "library_ms": library_ms, "bytes": bytes_, "flops": flops,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "shared_rows": sk.shared_rows(rows, c),
        "l2_reductions": plan["l2_reductions"],
        "updates_per_reduction": updates / max(plan["l2_reductions"], 1),
        "G_reductions_per_s": plan["l2_reductions"] / ms / 1e6,
        "flushes": plan["flushes"], "shared_adds": plan["shared_adds"],
        "window_flushes": plan["window_flushes"],
    }


def scatter_step_phase(method, cfg, tree, dev, aux=None):
    """scatter_add_rows against its plain version on the launches of one
    train step of ``method`` (scatter_step_cases); returns the rows
    ("order": "ray", with the grid and the method)."""
    layout = scatter_layout(dev)
    results = []
    for label, grid, operands in scatter_step_cases(method, cfg, tree, dev, aux):
        row = {**scatter_case(label, operands, layout, dev), "order": "ray",
               "grid": grid, "method": method}
        log("kernel", "scatter_add_rows", json.dumps(row))
        results.append(row)
        del operands
        torch.cuda.empty_cache()
    log(f"{method} train step launches of scatter_add_rows, ray-ordered: "
        f"{len(results)}, kernel {sum(r['ms'] for r in results):.4f} ms, plain "
        f"{sum(r['plain_ms'] for r in results):.4f} ms, library "
        f"{sum(r['library_ms'] for r in results):.4f} ms, bound "
        f"{sum(r['bound_ms'] for r in results):.4f} ms (bytes), "
        f"{sum(r['updates'] for r in results)} updates in "
        f"{sum(r['l2_reductions'] for r in results)} L2 reductions")
    return results


def scatter_kernel_phase(cfg, tree, dev):
    """scatter_add_rows against its plain version on scatter_random_cases
    and on the launches of one nerfacto train step (scatter_step_phase),
    then an empty update list; returns the rows."""
    from soccernerfs_tpu_torch.ops.kernels import scatter_kernels as sk

    layout = scatter_layout(dev)
    results = []
    for label, operands in scatter_random_cases(cfg, dev):
        row = {**scatter_case(label, operands, layout, dev), "order": "random"}
        log("kernel", "scatter_add_rows", json.dumps(row))
        results.append(row)
        del operands
        torch.cuda.empty_cache()
    results += scatter_step_phase(NERFACTO, cfg, tree, dev)
    empty = sk.scatter_add_rows(
        torch.zeros((0, 2), device=dev),
        torch.zeros((1, 8, 0), dtype=torch.int32, device=dev), None, rows=16)
    if empty.shape != (16, 2) or float(empty.abs().max()) != 0.0:
        raise AssertionError("scatter: an empty update list gave a non-zero table")
    return {"scatter_add_rows": results}


def scatter_in_step(method, rows, in_step):
    """The profiled steps' scatter_add_rows device time against the byte
    bound of ``method``'s captured launches (``rows``): an update step
    launches all of them, a non-update step the main field's only (no
    proposal grid's).  Fails unless the profiled step launched as many."""
    ray = [r for r in rows if r.get("method") == method]
    for update, (times, counts) in in_step.items():
        step = ray if update else [r for r in ray
                                   if not r["grid"].startswith("proposal")]
        bound, t = sum(r["bound_ms"] for r in step), times["scatter_add_rows"]
        if counts["scatter_add_rows"] != len(step):
            raise AssertionError(f"scatter_add_rows: {counts['scatter_add_rows']} "
                                 f"launches in the profiled {method} step, the "
                                 f"captured step made {len(step)}")
        log(f"in-step scatter_add_rows ({'update' if update else 'non-update'} "
            f"step) {method}: {t:.3f} ms device in {len(step)} launches, bound "
            f"{bound:.3f} ms (bytes), "
            + (f"{bound / t:.4f} of bound" if t else "not measured"))


def make_cameras(dev):
    from soccernerfs_tpu_torch.core.cameras import Cameras

    # camera 0: inside the box at its center, looking down -z (bench.py's
    # render camera); camera 1: outside the box on +z, looking at it
    c2w = np.zeros((2, 3, 4), np.float32)
    c2w[:, :, :3] = np.eye(3, dtype=np.float32)
    c2w[1, 2, 3] = 3.0
    return Cameras.create(
        camera_to_worlds=c2w, fx=800.0, fy=800.0, cx=W / 2, cy=H / 2,
        width=W, height=H, times=np.array([0.0, 0.5], np.float32), device=dev,
    )


def profile_device(label, fn, trace_path):
    """Device time by kernel over one call of ``fn``; busy share of the
    wall time.  Returns {kernel wrapper name: device ms} of the port's
    kernels (templates bilerp_{fwd,bwd}_kernel<F, packed>,
    scatter_add_rows_kernel<C> and kplanes_fwd_fused_kernel<F, P>)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if trace_path:
        Path(trace_path).parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(trace_path))
    rows = []
    for evt in prof.key_averages():
        # kernels only: an operator's row repeats the time of its kernels
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0))
        if dev_us > 0:
            rows.append((dev_us, evt.count, evt.key))
    rows.sort(reverse=True)
    total_us = sum(r[0] for r in rows)
    plane_us = sum(r[0] for r in rows
                   if "bilerp_" in r[2] or "scatter_add_rows_kernel" in r[2]
                   or "kplanes_fwd_fused_kernel" in r[2])
    # one stream: kernels do not overlap, so their sum is the busy time
    log(f"profile {label}: wall {wall * 1e3:.3f} ms (profiled), "
        f"{sum(r[1] for r in rows)} kernels, device kernel "
        f"time {total_us / 1e3:.3f} ms, busy share "
        + (f"{total_us / 1e6 / wall:.4f}, hand-written kernels' share "
           f"{plane_us / total_us:.4f}" if total_us else "not measured"))
    for dev_us, count, key in rows[:15]:
        log(f"profile {label}: {dev_us / 1e3:10.3f} ms {count:6d}x  {key[:90]}")
    times = {
        f"bilerp_{d}_{kind}": sum(r[0] for r in rows
                                  if f"bilerp_{d}_kernel<" in r[2] and flag in r[2]) / 1e3
        for d in ("fwd", "bwd")
        for kind, flag in (("unpacked", ", false>"), ("packed", ", true>"))
    }
    times["scatter_add_rows"] = sum(
        r[0] for r in rows if "scatter_add_rows_kernel<" in r[2]) / 1e3
    times["kplanes_fwd_fused"] = sum(
        r[0] for r in rows if "kplanes_fwd_fused_kernel<" in r[2]) / 1e3
    return times


def frame_plane_bound_ms(cfg, staged, n_chunks):
    """Least time the fused plane launches of one frame could take: per
    chunk, level (the proposal fields', the main field) and scale, the
    coordinates read (times given, so 4 a point) and the F f32 features
    written once, and the scale's whole staged tables read once, at the
    card's memory rate."""
    chunk = cfg.eval_num_rays_per_chunk
    levels = [
        (staged["proposal_networks"][f"proposal_{idx}"],
         chunk * cfg.num_proposal_samples_per_ray[it])
        for it, (idx, _d) in enumerate(cfg.density_field_configs())
    ]
    levels.append((staged["fields"], chunk * cfg.num_nerf_samples_per_ray))
    total = 0
    for params, m in levels:
        for grids, tables in zip(params["grids"], params["grids_packed"]):
            total += (m * 4 * 4 + m * grids[0].shape[-1] * 4
                      + sum(t.numel() * t.element_size() for t in tables))
    return {"kplanes_fwd_fused": total * n_chunks / H100_BYTES_PER_S * 1e3}


def cpu_stat():
    """The machine's CPU time counters (/proc/stat: user, nice, system,
    idle, iowait, irq, softirq, steal, ...)."""
    return [int(x) for x in Path("/proc/stat").read_text().split("\n")[0].split()[1:]]


def ring_cameras(dev):
    """bench.py's training cameras: 20 poses on a ring around the box,
    looking at the origin, 960x540, times linspace(0, 1)."""
    from soccernerfs_tpu_torch.core.cameras import Cameras

    n = 20
    c2w = np.zeros((n, 3, 4), np.float32)
    for i in range(n):
        th = 2 * np.pi * i / n
        z = np.array([np.cos(th), np.sin(th), 0.5])
        z = z / np.linalg.norm(z)
        x = np.cross(np.array([0.0, 0.0, 1.0]), z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        c2w[i, :, 0], c2w[i, :, 1], c2w[i, :, 2] = x, y, z
        c2w[i, :, 3] = z * 2.5
    return Cameras.create(
        camera_to_worlds=c2w, fx=800.0, fy=800.0, cx=480.0, cy=270.0,
        width=960, height=540, times=np.linspace(0, 1, n).astype(np.float32),
        device=dev,
    )


def make_batch(seed, rays, dev, depth=False, classes=0):
    """A batch in the JAX trainer's layout: random (camera, pixel) pairs of
    the ring, pixel centres, random colours, from a numpy seed; with
    ``depth``, target depths U(1.5, 4) (the ring's cameras are 2.5 from the
    box's centre), DEPTH_ZEROS of them 0 (no target); with ``classes``,
    "semantics" labels uniform in [0, classes), int32."""
    r = np.random.default_rng(seed)
    coords = np.stack([r.integers(0, 540, rays), r.integers(0, 960, rays)], -1)
    batch = {
        "cam_idx": torch.from_numpy(r.integers(0, 20, rays).astype(np.int32)).to(dev),
        "coords": torch.from_numpy(coords.astype(np.float32) + 0.5).to(dev),
        "image": torch.from_numpy(r.uniform(0, 1, (rays, 3)).astype(np.float32)).to(dev),
    }
    if depth:
        target = r.uniform(1.5, 4.0, rays).astype(np.float32)
        target[r.uniform(0, 1, rays) < DEPTH_ZEROS] = 0.0
        batch["depth_image"] = torch.from_numpy(target).to(dev)
    if classes:
        batch["semantics"] = torch.from_numpy(
            r.integers(0, classes, rays).astype(np.int32)).to(dev)
    return batch


def method_batch(seed, rays, dev, method):
    """``make_batch`` with what ``method`` trains on: target depths for
    depth-nerfacto, class labels for a semantic model."""
    _module, cfg, _camera_optimizer = method_parts(method)
    return make_batch(seed, rays, dev, depth=method == DEPTH,
                      classes=getattr(cfg, "num_semantic_classes", 0))


def is_update_step(module, cfg, state) -> bool:
    """Whether the state's next step is an update step: an occupancy
    model's grid update (``update_due``), else a proposal update
    (``host_static_kwargs`` on a copy of the host counter)."""
    if hasattr(module, "update_due"):
        return module.update_due(cfg, state.step)
    return module.host_static_kwargs(
        cfg, state.step, {"steps_since_update": state.steps_since_update}
    )["train_proposal_networks"]


def set_step_kind(module, cfg, state, update: bool) -> None:
    """Move the state so that its next step is an update step, or not."""
    if hasattr(module, "update_due"):
        every = cfg.occ.update_every
        if update:
            state.step = -(-state.step // every) * every
        elif state.step % every == 0:
            state.step += 1
    else:
        # the step after an update is a non-update one; after 5 non-update
        # steps the next updates
        state.steps_since_update = 5 if update else 0


def train_phase(method, tree, dev, trace_dir, must_launch, every_step=(),
                aux=None, window=None, sub=12):
    """A method's train main path, counted: steps 0-11 and a window of
    ``window`` steps (default TRAIN_WINDOW) at step 10,000 (sub-windows of
    ``sub`` steps), with the
    method's registered optimizers and camera optimizer, from the model
    state ``aux`` (an occupancy model's grid; else its ``init_aux``).
    Fails unless every kernel of ``must_launch`` launched during it, and
    those of ``every_step`` on every step, and unless an occupancy model's
    grid moved at step 0 and over the window.  Returns the launch counts
    and, for the profiled update and non-update step, the device time per
    kernel and the launches."""
    from soccernerfs_tpu_torch.configs.method_configs import train_num_rays_per_batch
    from soccernerfs_tpu_torch.ops.kernels import scatter_kernels as sk
    from soccernerfs_tpu_torch.utils.tree import tree_leaves

    module, cfg, _camera_optimizer = method_parts(method)
    occupancy = hasattr(module, "update_aux")
    window = window or TRAIN_WINDOW
    tag = f"train {method}"
    rays = train_num_rays_per_batch[method]
    trainer, state = make_trainer(method, tree, dev, aux)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    batches = [method_batch(i, rays, dev, method) for i in range(8)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    reset_launch_counts()
    # step 0 as train_iteration runs it, with its gradients kept: every one
    # must be finite
    t0 = time.perf_counter()
    loss, _ld, _m, grads = trainer.loss_and_grads(
        state, batches[0], train_proposal_networks=True, generator=gen)
    bad = [i for i, g in enumerate(grads)
           if g is not None and not bool(torch.isfinite(g).all())]
    if bad or not bool(torch.isfinite(loss)):
        raise AssertionError(f"step 0: loss {float(loss)}, non-finite "
                             f"gradients at leaves {bad}")
    if any(g is None for g in grads):
        raise AssertionError("step 0 (an update step) left a leaf without "
                             "a gradient")
    trainer.apply_grads(state, grads)
    if occupancy:
        # and the grid update after it: over all cells at step 0
        grid0 = state.aux["occs"]
        state.aux = module.update_aux(cfg, state.params, trainer.aabb, 0,
                                      state.aux, gen)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    sk.raise_if_out_of_range(dev)
    del grads
    if occupancy and torch.equal(grid0, state.aux["occs"]):
        raise AssertionError(f"{method}: the grid did not move at step 0")
    # the first leaf of every param group (the camera optimizer's too)
    watch = [tree_leaves(group)[0] for group in state.params.values()]
    before = [w.detach().clone() for w in watch]

    def run(steps, times):
        """``steps`` train iterations from the state's step, each timed by
        the host clock to a synchronised end and by the process's CPU
        time; appends (update step?, wall s, CPU s) to ``times``."""
        for _ in range(steps):
            update = is_update_step(module, cfg, state)
            counts = launch_counts()
            t0, c0 = time.perf_counter(), time.process_time()
            m = trainer.train_iteration(state, batches[state.step % 8], gen)
            torch.cuda.synchronize()
            times.append((update, time.perf_counter() - t0,
                          time.process_time() - c0))
            sk.raise_if_out_of_range(dev)
            for name in every_step:
                if launch_counts()[name] <= counts[name]:
                    raise AssertionError(f"step {state.step - 1}: {name} was "
                                         f"not launched")
            if not all(bool(torch.isfinite(v)) for v in m.values()):
                raise AssertionError(f"step {state.step - 1}: non-finite {m}")
        return m

    def ms(times, update):
        ts = np.array([t for u, t, _c in times if u == update]) * 1e3
        return (f"{len(ts)} x {ts.mean():.3f} ms mean, median "
                f"{np.median(ts):.3f}, min {ts.min():.3f}, max {ts.max():.3f}"
                if len(ts) else "none")

    warm = []
    run(1, warm)
    stuck = [name for name, b, w in zip(state.params, before, watch)
             if torch.equal(b, w.detach())]
    if stuck:
        raise AssertionError(f"param groups {stuck} did not move by step 1 "
                             f"(lr > 0)")
    del before
    m = run(10, warm)
    log(f"{tag}: step 0 {first * 1e3:.3f} ms (first, with warm-up); steps "
        f"1-11: update steps {ms(warm, True)}; non-update steps "
        f"{ms(warm, False)}; loss {float(m['Train Loss']):.6f}, psnr "
        f"{float(m['psnr']):.4f}")

    # the window: whole update cycles (a proposal update every sixth step,
    # a grid update every sixteenth), so each sub-window holds the same mix
    state.step, state.steps_since_update = 10_000, 0
    grid0 = state.aux.get("occs")
    times = []
    load, stat = os.getloadavg()[0], cpu_stat()
    m = run(window, times)
    stat = [b - a for a, b in zip(stat, cpu_stat())]
    wall = np.array([t for _u, t, _c in times])
    cpu = np.array([c for _u, _t, c in times])
    subs = rays * sub / wall.reshape(-1, sub).sum(1)
    WINDOW_RAYS_PER_S[method] = rays * window / wall.sum()
    launches = launch_counts()
    log(f"{tag}: window steps 10000-{10000 + window - 1}: update steps "
        f"{ms(times, True)}; non-update steps {ms(times, False)}; "
        f"{rays * window / wall.sum():.1f} train rays/s over the "
        f"window; {sub}-step sub-windows {[round(float(r), 1) for r in subs]} "
        f"train rays/s (median {np.median(subs):.1f}, min {subs.min():.1f}, "
        f"max {subs.max():.1f}); process CPU time per step {cpu.mean() * 1e3:.3f} "
        f"ms mean ({cpu.sum() / wall.sum():.4f} of the wall time; correlation "
        f"with the step's wall time {np.corrcoef(cpu, wall)[0, 1]:.4f}); "
        f"host: steal {stat[7] / max(sum(stat[:8]), 1):.4f} of the CPUs' time, load "
        f"average (1 min) {load:.2f} before, "
        f"{os.getloadavg()[0]:.2f} after, {os.cpu_count()} CPUs; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; loss "
        f"{float(m['Train Loss']):.6f}; launches {launches}")
    for name in must_launch:
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched by the {method} "
                                 f"train path")
    if occupancy:
        occs = state.aux["occs"]
        if torch.equal(grid0, occs):
            raise AssertionError(f"{method}: the grid did not move over the window")
        log(f"{tag}: grid after the window: occupied "
            f"{float(module.eval_kwargs(cfg, state.aux)['occ_binary'].float().mean()):.4f}"
            f" of {occs.numel()} cells, mean {float(occs.mean()):.6e}")

    # where one non-update step's wall time goes: forward, losses and
    # backward, then the optimizer update (host clock, synchronised)
    t0 = time.perf_counter()
    _l, _d, _m, grads = trainer.loss_and_grads(
        state, batches[1], train_proposal_networks=False, generator=gen)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    trainer.apply_grads(state, grads)
    torch.cuda.synchronize()
    sk.raise_if_out_of_range(dev)
    log(f"{tag}: one non-update step split: forward + losses + backward "
        f"{(t1 - t0) * 1e3:.3f} ms, optimizer update "
        f"{(time.perf_counter() - t1) * 1e3:.3f} ms")
    del grads

    in_step = {}
    for update in (True, False):
        label = "update step" if update else "non-update step"
        set_step_kind(module, cfg, state, update)
        reset_launch_counts()
        times = profile_device(
            f"{tag} {label}",
            lambda: trainer.train_iteration(state, batches[0], gen),
            Path(trace_dir) / f"train_{method}_{label.replace(' ', '_')}_trace.json"
            if trace_dir else None)
        in_step[update] = (times, launch_counts())
        sk.raise_if_out_of_range(dev)
        log(f"{tag}: launches in one {label}: {in_step[update][1]}")
    del state, trainer, batches
    torch.cuda.empty_cache()
    return launches, in_step


def leaf_paths(tree, prefix=""):
    """Names of a param tree's leaves, in tree_leaves order."""
    if isinstance(tree, dict):
        return [q for k, v in tree.items() for q in leaf_paths(v, f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [q for i, v in enumerate(tree) for q in leaf_paths(v, f"{prefix}{i}/")]
    return [prefix[:-1]]


@contextlib.contextmanager
def pdf_bins(record=None, replay=None):
    """While open, the proposal sampler's PDF resamplings append their
    RaySamples to ``record``; or, with ``replay``, each takes the bins of
    the next recorded one (moved to its device) in place of its own."""
    from soccernerfs_tpu_torch.ops import samplers

    orig = samplers.pdf_samples
    # the modules that call it: the samplers' own proposal sampler, and
    # the models and the NeuS sampler, which import it by name
    users = [samplers] + [m for name, m in list(sys.modules.items())
                          if name.startswith(("soccernerfs_tpu_torch.models.",
                                              "soccernerfs_tpu_torch.ops."))
                          and m is not samplers
                          and getattr(m, "pdf_samples", None) is orig]
    it = iter(replay or ())

    def patched(*a, **k):
        out = orig(*a, **k)
        if replay is None:
            record.append(out)
            return out
        rec = next(it)
        return out.replace(**{
            f: getattr(rec, f).to(out.starts.device)
            for f in ("starts", "ends", "spacing_starts", "spacing_ends")})

    for module in users:
        module.pdf_samples = patched
    try:
        yield
    finally:
        for module in users:
            module.pdf_samples = orig


@contextlib.contextmanager
def one_ulp_directions():
    """While open, the train step's rays have every other direction
    component moved up by one f32 ulp."""
    from soccernerfs_tpu_torch.engine import trainer

    orig = trainer.generate_rays

    def patched(*a, **k):
        rays = orig(*a, **k)
        d = rays.directions
        # d + (its next float up - d) is that float, and keeps d's gradient
        # (the camera optimizer's)
        up = torch.nextafter(d.detach(), torch.full_like(d, 2.0)) - d.detach()
        every_other = (torch.arange(d.numel(), device=d.device) % 2 == 0)
        return rays.replace(directions=d + torch.where(
            every_other.reshape(d.shape), up, torch.zeros_like(up)))

    trainer.generate_rays = patched
    try:
        yield
    finally:
        trainer.generate_rays = orig


def tree_to(tree, device):
    """A param tree's leaves, detached, on ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_to(v, device) for v in tree]
    return tree.detach().to(device)


def selection_differs(a, b):
    """[N] bool: the rays whose samples differ between two forwards (their
    valid masks, or the probes they selected, read from the samples'
    spacing starts); the outputs on the CPU."""
    return ((a["valid"] != b["valid"]).any(-1)
            | (a["spacing_starts"] != b["spacing_starts"]).any(-1))


def is_classic(module) -> bool:
    """Whether a model module is one of the classic methods' (vanilla NeRF,
    mip-NeRF, TensoRF) or NeuS: PDF samplers over MLP fields, no
    hand-written kernel."""
    return module.__name__.rsplit(".", 1)[-1] in ("vanilla_nerf", "mipnerf",
                                                  "tensorf", "neus")


def train_cpu_check(method, tree, dev, seeds, witnesses, aux=None, rays=None):
    """One step of ``rays`` (default TRAIN_CPU_RAYS) rays on the card and on
    the CPU (the kernels' plain versions), same params, batch and draws,
    proposal update on, the method's camera optimizer as registered, for
    each of ``seeds``: the loss terms and every gradient before the update.
    With ``witnesses``, two more CPU steps show what sets the gradients'
    worst elements: one takes the card's PDF bins in place of its own, and
    one also moves the ray directions by one ulp (the CPU against itself:
    the step's own sensitivity to rounding).

    A classic method (``is_classic``; run with the witnesses) holds its
    leaves with the card's bins on both sides, each within GRAD_L2_TOL or
    twice its one-ulp witness where that is larger: vanilla NeRF's first
    layers move by ~0.1 in L2 under one ulp of the directions (the top
    frequency of its encoding and ten bf16 layers; see
    tests/test_torch_classic_methods.py).

    An occupancy model (its grid state ``aux``) steps at OCC_CPU_STEP,
    whose grid update is a sampled one: the rays whose samples differ
    between the two forwards are counted (at most SELECTION_TOL of them),
    and both sides then update the same grid with the same draws from the
    card's updated params; the grids agree within OCCS_L2_TOL in L2."""
    from soccernerfs_tpu_torch.ops.kernels import scatter_kernels as sk

    module, cfg, camera_optimizer = method_parts(method)
    occupancy = hasattr(module, "update_aux")
    classic = is_classic(module)
    step = OCC_CPU_STEP if occupancy else 300
    n = rays or TRAIN_CPU_RAYS
    cpu = torch.device("cpu")
    trainers, states = {}, {}

    def compare(a_run, b_run):
        """Loss terms |a - b| / |b|; per leaf, (|a - b| / |b| in L2,
        max |a - b| / max |b|, leaf name), worst L2 first."""
        terms = {k: abs(a_run[0][k] - v) / max(abs(v), 1e-30)
                 for k, v in b_run[0].items()}
        rows = []
        for a, b, name in zip(a_run[1], b_run[1], leaf_paths(states[cpu].params)):
            if (a is None) != (b is None):
                raise AssertionError(f"{name}: gradient on one run only")
            if a is not None:
                rows.append((float((a - b).norm() / b.norm().clamp(min=1e-30)),
                             float((a - b).abs().max()
                                   / b.abs().max().clamp(min=1e-30)), name))
        rows.sort(reverse=True)
        return terms, rows

    def fmt(rows):
        return ", ".join(f"{name} {l2:.3e} / {mx:.3e}" for l2, mx, name in rows)

    results = []
    tag = f"train cpu check {method}"
    single = getattr(cfg, "use_single_jitter", False)
    for seed in seeds:
        if occupancy or not trainers:
            # an occupancy check applies the card's step: fresh states
            for d in (dev, cpu):
                trainers[d], states[d] = make_trainer(method, tree, d, aux)
        if occupancy or classic:
            gen = torch.Generator().manual_seed(seed)
            draws = module.train_draws(cfg, n, gen, cpu)
            jitters, background = draws["jitters"], draws["background"]
            tv_rows = [int(r) for r in draws.get("tv_rows", [])] or None
            grid_draws = (module.aux_draws(cfg, step, gen, cpu) if occupancy
                          else None)
        else:
            rng = np.random.default_rng(seed)
            jitters = [torch.from_numpy(rng.uniform(
                0, 1, (n, 1 if single else s + 1)).astype(np.float32))
                for s in module.sample_counts(cfg)]
            background = torch.from_numpy(
                rng.uniform(0, 1, (n, 3)).astype(np.float32))
            # the temporal TV's index_list rows, for the models that have it
            tv_rows = ([int(rng.integers(0, g.temporal_dim - 1))
                        for g in module.tv_grids(cfg)]
                       if hasattr(module, "tv_grids") else None)

        def step_draws(d):
            return {"jitters": [j.to(d) for j in jitters],
                    "background": None if background is None else background.to(d)}

        bins = []
        out = {}
        runs = [("card", dev, [pdf_bins(record=bins)]), ("cpu", cpu, [])]
        if witnesses:
            runs += [("cpu, card's bins", cpu, [pdf_bins(replay=bins)]),
                     ("cpu, card's bins, directions + 1 ulp", cpu,
                      [pdf_bins(replay=bins), one_ulp_directions()])]
        for where, d, patches in runs:
            state = states[d]
            state.step = step
            t0 = time.perf_counter()
            with contextlib.ExitStack() as stack:
                for patch in patches:
                    stack.enter_context(patch)
                loss, ld, _m, grads = trainers[d].loss_and_grads(
                    state, method_batch(seed + 1, n, d, method),
                    train_proposal_networks=True, tv_rows=tv_rows,
                    **step_draws(d))
            loss = float(loss)
            sk.raise_if_out_of_range(d)
            out[where] = ({"Train Loss": loss,
                           **{k: float(v) for k, v in ld.items()}},
                          [None if g is None else g.cpu() for g in grads])
            log(f"{tag}, seed {seed}: {where} step "
                f"{time.perf_counter() - t0:.3f} s")
            del grads
        pairs = {"card vs cpu": compare(out["card"], out["cpu"])}
        if witnesses:
            pairs.update({
                "card vs cpu, both the card's bins":
                    compare(out["card"], out["cpu, card's bins"]),
                "cpu vs cpu, directions + 1 ulp, both the card's bins":
                    compare(out["cpu, card's bins, directions + 1 ulp"],
                            out["cpu, card's bins"]),
            })
        for label, (t, r) in pairs.items():
            log(f"{tag}, seed {seed} ({n} rays, step {step}, proposal "
                f"update on), {label}: loss terms |a - b| / |b| max "
                f"{max(t.values()):.3e} ({max(t, key=t.get)}); gradients "
                f"|a - b| / |b| in L2, worst: {fmt(r[:3])}; max |a - b| / "
                f"max |b|, worst: {fmt(sorted(r, key=lambda x: -x[1])[:3])}")
        card_grads = out["card"][1]
        del out, bins
        # Loss terms: f32 sums in another order.  Gradients: when its inputs
        # move by one ulp, the step moves single elements of the finest
        # planes by up to ~10 % of a leaf's max (the last witness: the CPU
        # against itself), because the MLPs round their operands to bf16
        # and a flipped rounding is a 2^-8 step (with f32 MLPs that
        # sensitivity falls below 1e-5: tests/test_torch_train_step.py,
        # test_one_ulp_sensitivity_comes_from_the_bf16_mlp).  Card and CPU
        # round f32 sums differently all along the step, so their
        # difference is of that size, with the PDF bins shared or not.
        # So single elements are not held; each leaf is, in L2 (K-Planes'
        # TV gradient over every entry keeps the norm stable; nerfacto's
        # leaves, the pose adjustments included, sum over many samples).
        #
        # The deformation MLP's leaves are held at DEFORM_L2_TOL: their
        # gradient is the deformed points' encode gradient, whose
        # multilinear-weight factor jumps at every cell face, and a flipped
        # bf16 rounding in the deformation MLP moves a deformed point by
        # ~2^-8 of its offset, a cell or more at the finest levels (~4096
        # cells a side).  The one-ulp witness shows the CPU's own step
        # moving these leaves by as much.
        terms, rows = pairs["card vs cpu"]
        if not any(name == "camera_opt/pose_adjustment" for _l, _m, name in rows
                   ) and camera_optimizer.mode != "off":
            raise AssertionError("the camera optimizer got no gradient")
        if classic:
            witness = {name: l2 for l2, _m, name in pairs[
                "cpu vs cpu, directions + 1 ulp, both the card's bins"][1]}
            shared = pairs["card vs cpu, both the card's bins"][1]
            bounds = {name: max(GRAD_L2_TOL, 2 * witness[name])
                      for _l, _m, name in shared}
            bad = [r for r in shared if r[0] > bounds[r[2]]]
            held = sorted(name for name, b in bounds.items() if b > GRAD_L2_TOL)
            log(f"{tag}, seed {seed}: leaves held with the card's bins on "
                f"both sides, at {GRAD_L2_TOL} or twice their one-ulp "
                f"witness: {len(held)} of {len(bounds)} at their witness"
                + (f" ({', '.join(held[:4])}{', ...' if len(held) > 4 else ''})"
                   if held else ""))
            if max(terms.values()) > 1e-4 or bad:
                raise AssertionError(
                    f"card and CPU {method} train steps disagree, seed "
                    f"{seed}: {terms}, gradients {bad}")
            del card_grads
            results.append(pairs)
            continue
        deform = [r for r in rows if r[2].startswith(DEFORM_PREFIX)]
        if deform:
            log(f"{tag}, seed {seed}: deformation MLP leaves in L2, "
                + "; ".join(f"{label} {fmt([r for r in p[1] if r[2].startswith(DEFORM_PREFIX)][:2])}"
                            for label, p in pairs.items())
                + f" (held at {DEFORM_L2_TOL}, the other leaves at {GRAD_L2_TOL})")
        bad = [r for r in rows if r[0] > (DEFORM_L2_TOL if r[2].startswith(
            DEFORM_PREFIX) else GRAD_L2_TOL)]
        if max(terms.values()) > 1e-4 or bad:
            raise AssertionError(
                f"card and CPU {method} train steps disagree, seed {seed}: {terms}, "
                f"gradients {bad}")
        if occupancy:
            occupancy_cpu_check(module, cfg, trainers, states, dev, seed,
                                step_draws, card_grads, grid_draws, tag)
        del card_grads
        results.append(pairs)
    del trainers, states
    return results


def occupancy_cpu_check(module, cfg, trainers, states, dev, seed, step_draws,
                        card_grads, grid_draws, tag):
    """The occupancy half of a train CPU check (train_cpu_check): the
    forwards' selections on both sides, then the card's step applied and
    the grid update from its params on both sides, same grid and draws."""
    from soccernerfs_tpu_torch.core.cameras import generate_rays

    cpu = torch.device("cpu")
    n = TRAIN_CPU_RAYS
    step = states[cpu].step
    picked = {}
    for where, d in (("card", dev), ("cpu", cpu)):
        batch = make_batch(seed + 1, n, d)
        rays = generate_rays(trainers[d].cameras, batch["cam_idx"], batch["coords"])
        with torch.no_grad():
            o = module.get_outputs(cfg, states[d].params, trainers[d].aabb, rays,
                                   train=True, **step_draws(d),
                                   **module.schedules(cfg, step, states[d].aux))
        picked[where] = {"valid": o["valid"].cpu(),
                         "spacing_starts": o["ray_samples"].spacing_starts.cpu()}
    differ = int(selection_differs(picked["card"], picked["cpu"]).sum())
    alive = float(picked["cpu"]["valid"].any(-1).float().mean())
    trainers[dev].apply_grads(states[dev], [None if g is None else g.to(dev)
                                            for g in card_grads])
    grids = {}
    for where, d, params in (("card", dev, states[dev].params),
                             ("cpu", cpu, tree_to(states[dev].params, cpu))):
        t0 = time.perf_counter()
        grids[where] = module.update_aux(
            cfg, params, trainers[d].aabb, step, states[d].aux,
            draws={k: v.to(d) for k, v in grid_draws.items()})["occs"].cpu()
        torch.cuda.synchronize()
        log(f"{tag}, seed {seed}: {where} grid update (step {step}, "
            f"{grid_draws['jitter'].shape[0]} probes) "
            f"{time.perf_counter() - t0:.3f} s")
    a, b = grids["card"], grids["cpu"]
    l2 = float((a - b).norm() / b.norm())
    mx = float((a - b).abs().max() / b.abs().max())
    moved = int((b != states[cpu].aux["occs"]).sum())
    log(f"{tag}, seed {seed}: rays whose samples differ (valid mask or "
        f"probes) {differ} of {n} (alive {alive:.4f}); grid after the "
        f"update: |card - cpu| / |cpu| in L2 {l2:.3e}, max |card - cpu| / "
        f"max |cpu| {mx:.3e}, {moved} cells moved")
    # a probe on a cell's face may fall either way under the rays' last-bit
    # differences; the grid's densities pass through the bf16 MLPs
    if differ > SELECTION_TOL * n or l2 > OCCS_L2_TOL or moved == 0:
        raise AssertionError(f"card and CPU {tag} disagree: {differ} rays "
                             f"select differently, grid {l2} in L2")


def render_phase(method, params, cams, dev, aabb, trace_dir, must_launch=(),
                 aux=None, frames=(0, 1), steady=(0, 1), profile=True,
                 must_not_launch=()):
    """A method's render main path, counted: whole frames of the cameras
    ``frames`` through ``render_camera`` (with the model state ``aux``, an
    occupancy model's grid), every kernel of ``must_launch`` launched and
    none of ``must_not_launch``; then timed frames of the cameras ``steady``
    (none: the counted frames' times stand for them) and, with
    ``profile``, one profiled frame.  Returns the counted frames' launches
    and the profiled frame's device time per kernel (empty without
    one)."""
    from soccernerfs_tpu_torch.configs.method_configs import model_names
    from soccernerfs_tpu_torch.engine.render import render_camera

    _module, cfg, _camera_optimizer = method_parts(method)
    tag = f"render {method}"

    def frame(i):
        return render_camera(cfg, params, cams, i, device=dev, aabb=aabb,
                             model=model_names[method], aux=aux)

    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    counted = list(frames)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frames = [frame(i) for i in counted]
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = launch_counts()
    log(f"{tag}: {len(frames)} frames {W}x{H} in {first_s:.3f} s (first "
        f"frames), launches {launches}")
    for name in must_launch:
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched by the {method} "
                                 f"render path")
    for name in must_not_launch:
        if launches[name] != 0:
            raise AssertionError(f"{name} was launched {launches[name]} times "
                                 f"by the {method} render path")
    for i, fr in enumerate(frames):
        rgb, depth, acc = fr["rgb"], fr["depth"], fr["accumulation"]
        assert rgb.shape == (H, W, 3) and depth.shape == (H, W), (rgb.shape, depth.shape)
        assert acc.shape == (H, W)
        for k, v in fr.items():
            assert bool(torch.isfinite(v).all()), f"{method} frame {i} {k} not finite"
        assert float(rgb.min()) >= 0.0 and float(rgb.max()) <= 1.0
        assert float(acc.min()) >= 0.0 and float(acc.max()) <= 1.0 + 1e-4
        if "probs" in fr:
            # the rendered component probabilities sum to the accumulation
            probs = fr["probs"]
            assert probs.shape == (H, W, 3) and float(probs.min()) >= 0.0
            assert float((probs.sum(-1) - acc).abs().max()) <= 1e-4
        log(f"{tag}: frame {i}: rgb mean {float(rgb.mean()):.6f}, acc mean "
            f"{float(acc.mean()):.6f}, depth mean {float(depth.mean()):.6f}")
    del frames

    # steady-state frame time
    times = []
    for i in steady:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frame(i)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    if not times:
        times = [first_s / len(counted)]
    per_frame = sum(times) / len(times)
    log(f"{tag}: steady {per_frame:.4f} s/frame ({times}"
        f"{'' if steady else ', the counted frames'}), "
        f"{H * W / per_frame:.1f} test rays/s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    if not profile:
        return launches, {}
    reset_launch_counts()
    in_frame = profile_device(
        f"{tag} frame", lambda: frame(1),
        Path(trace_dir) / f"render_{method}_frame_trace.json" if trace_dir else None)
    log(f"{tag}: launches per frame {launch_counts()}")
    return launches, in_frame


def render_cpu_check(method, tree, params, cams, dev, aabb, aux=None, n=4096,
                     parts=None):
    """One chunk of ``n`` rays through the model on the card and on the CPU
    (the kernels' plain versions); an occupancy model's on the card's
    binary grid of ``aux`` on both sides, the rays whose samples differ
    counted and left out of the comparison.  ``parts``: the (model module,
    model config) of a snapshot, in place of the registered method's."""
    from soccernerfs_tpu_torch.convert import params_from_jax
    from soccernerfs_tpu_torch.core.cameras import generate_rays

    module, cfg = parts or method_parts(method)[:2]
    pix = np.linspace(0, H * W - 1, n).astype(np.int64)
    coords = np.stack([pix // W, pix % W], -1).astype(np.float32) + 0.5
    cpu = torch.device("cpu")
    params_cpu = params_from_jax(tree, device=cpu)
    if hasattr(module, "prepare_render_params"):
        params_cpu = module.prepare_render_params(cfg, params_cpu)
    # a random background: the same draws on both sides
    background = (np.random.default_rng(SEED).uniform(0, 1, (n, 3))
                  .astype(np.float32)
                  if getattr(cfg, "background_color", None) == "random" else None)
    extra = {} if aux is None else module.eval_kwargs(cfg, aux)
    outs, picked = {}, {}
    for where, d, p in (("card", dev, params), ("cpu", cpu, params_cpu)):
        rays = generate_rays(cams.to(d), torch.zeros(n, dtype=torch.int32,
                                                     device=d),
                             torch.from_numpy(coords).to(d))
        with torch.no_grad():
            o = module.get_outputs(
                cfg, p, aabb.to(d), rays,
                **{k: v.to(d) for k, v in extra.items()},
                **({} if background is None
                   else {"background": torch.from_numpy(background).to(d)}))
        outs[where] = {k: o[k].cpu() for k in ("rgb", "accumulation", "depth",
                                               "probs", "semantics", "normals")
                       if k in o}
        if "valid" in o:
            picked[where] = {"valid": o["valid"].cpu(),
                             "spacing_starts": o["ray_samples"].spacing_starts.cpu()}
    keep = torch.ones(n, dtype=torch.bool)
    if picked:
        keep = ~selection_differs(picked["card"], picked["cpu"])
        alive = float(picked["cpu"]["valid"].any(-1).float().mean())
        samples = float(picked["cpu"]["valid"].sum(-1).float().mean())
        log(f"cpu check {method} ({n} rays): rays whose samples differ (valid "
            f"mask or probes) {int((~keep).sum())} of {n}; alive "
            f"{alive:.4f}, {samples:.3f} valid samples per ray")
        if int((~keep).sum()) > SELECTION_TOL * n:
            raise AssertionError(f"card and CPU select different samples on "
                                 f"{int((~keep).sum())} rays of {method}")
    diffs = {k: float((outs["card"][k] - outs["cpu"][k])[keep].abs().max())
             for k in outs["cpu"]}
    depth_rel = ((outs["card"]["depth"] - outs["cpu"]["depth"]).abs()
                 / outs["cpu"]["depth"].abs().clamp(min=1e-6))[keep]
    depth_off = float((depth_rel > 1e-3).float().mean())
    log(f"cpu check {method} ({n} rays): max |card - cpu| {diffs}, depth rays "
        f"off by >1e-3 rel: {depth_off}")
    # rgb/accumulation (and NeRFPlayer's rendered probabilities,
    # semantic-NeRF-W's composited logits) are continuous in every input:
    # 2e-3 covers f32 reduction-order differences through the MLPs and the
    # PDF resampling; the median depth jumps where the cumulative weight
    # sits at 0.5.  NeuS composites with the reference's ~1e-5 alphas
    # (ROADMAP C.25), in which p + 1e-5 nearly cancels: its accumulation
    # stays below 1e-3, so its rgb and accumulation are held relative to
    # their largest value (NEUS_REL_TOL), its unit normals at NORMALS_TOL,
    # and its depth, which never reaches the cumulative weight 0.5 and is
    # the last midpoint on both sides, carries nothing
    absolute = {k: v for k, v in diffs.items() if k not in ("depth", "normals")}
    rel = {}
    if method == NEUS:
        rel = {k: absolute.pop(k) / max(float(outs["cpu"][k].abs().max()), 1e-30)
               for k in ("rgb", "accumulation")}
        log(f"cpu check {method} ({n} rays): max |card - cpu| / max |cpu| {rel}, "
            f"max accumulation {float(outs['cpu']['accumulation'].max())}")
        if not float(outs["cpu"]["accumulation"].max()) > 0.0:
            raise AssertionError(f"{method} renders nothing: zero accumulation")
    if (max(absolute.values(), default=0.0) > 2e-3
            or max(rel.values(), default=0.0) > NEUS_REL_TOL
            or diffs.get("normals", 0.0) > NORMALS_TOL or depth_off > 0.01):
        raise AssertionError(f"card and CPU disagree on {method}: {diffs}, "
                             f"{rel}, {depth_off}")


def occupancy_state(method, params, dev) -> dict:
    """An occupancy model's grid state at ``params``: an empty grid's
    all-cells update (``update_aux`` at step 0, its draws from a seeded
    generator).  Prints its time, first and again (host clock,
    synchronised), and its occupied share."""
    module, cfg, _camera_optimizer = method_parts(method)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def update():
        empty = module.init_aux(cfg, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = module.update_aux(cfg, params, torch.tensor(AABB, device=dev), 0,
                                empty, gen)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    aux, first_s = update()
    _, again_s = update()
    binary = module.eval_kwargs(cfg, aux)["occ_binary"]
    occs = aux["occs"]
    log(f"occupancy {method}: one all-cells update of the "
        f"{cfg.occ.resolution}^3 grid in {first_s:.3f} s (first, with "
        f"warm-up), {again_s:.4f} s (again); occupied "
        f"{float(binary.float().mean()):.4f} of "
        f"{occs.numel()} cells (seeded weights: a fog), occs mean "
        f"{float(occs.mean()):.6e}, min {float(occs.min()):.6e}, max "
        f"{float(occs.max()):.6e}")
    return aux


def make_params(method, dev, **seed_args):
    """(numpy tree, params on the card, params staged for rendering) of a
    method, the tree from ``seeded_params`` at SEED."""
    from soccernerfs_tpu_torch.convert import params_from_jax, seeded_params
    from soccernerfs_tpu_torch.utils.tree import tree_leaves

    module, cfg, _camera_optimizer = method_parts(method)
    t0 = time.perf_counter()
    tree = seeded_params(cfg, SEED, **seed_args)
    params = params_from_jax(tree, device=dev)
    staged = (module.prepare_render_params(cfg, params)
              if hasattr(module, "prepare_render_params") else params)
    torch.cuda.synchronize()
    n_params = sum(int(np.prod(a.shape)) for a in tree_leaves(tree))
    log(f"params {method}: {n_params} ({n_params * 4 / 2**20:.1f} MiB f32), "
        f"made and staged in {time.perf_counter() - t0:.3f} s")
    return tree, params, staged


def proposal_method_phases(method, dev, cams, aabb, trace_dir, kernels,
                           launches) -> None:
    """A temporal proposal method's phases (nerfplayer-nerfacto, nerfplayer):
    render and check a chunk on the CPU; the scatter's launches of a train
    step; train (4096-ray batches, a proposal update every sixth step at
    the window) and check a step on the CPU.  Adds to ``kernels`` and
    ``launches``."""
    from soccernerfs_tpu_torch.ops.kernels import scatter_kernels as sk

    scatter = [k.__name__ for k in sk.KERNELS]
    _module, cfg, _camera_optimizer = method_parts(method)
    tree, params, _ = make_params(method, dev, num_train_data=20)
    # nerfplayer's frame (~16 k kernels) is not profiled: 12.5 s
    launches[f"render {method}"], _ = render_phase(
        method, params, cams, dev, aabb, trace_dir, profile=method != NP)
    render_cpu_check(method, tree, params, cams, dev, aabb)
    del params
    torch.cuda.empty_cache()
    kernels["scatter_add_rows"] += scatter_step_phase(method, cfg, tree, dev)
    launches[f"train {method}"], in_step = train_phase(
        method, tree, dev, trace_dir, must_launch=scatter, every_step=scatter)
    for update, (times, _counts) in in_step.items():
        log(f"in-step kernels, {method} ({'update' if update else 'non-update'} "
            f"step): " + ", ".join(f"{k} {v:.3f} ms" for k, v in times.items()))
    scatter_in_step(method, kernels["scatter_add_rows"], in_step)
    # nerfplayer's deformation MLP leaves need the witnesses (train_cpu_check)
    train_cpu_check(method, tree, dev, NERFPLAYER_CPU_SEEDS,
                    witnesses=method == NP)
    del tree
    torch.cuda.empty_cache()


def occupancy_method_phases(method, dev, cams, aabb, trace_dir, kernels,
                            launches) -> None:
    """An occupancy-grid method's phases: the grid state from one all-cells
    update at the seeded weights; render with it and check a chunk on the
    CPU; the scatter's launch of a train step from that state; train from
    it (8192-ray batches, the grid updated every 16 steps) and check a
    step on the CPU.  Adds to ``kernels`` and ``launches``."""
    from soccernerfs_tpu_torch.ops.kernels import scatter_kernels as sk

    scatter = [k.__name__ for k in sk.KERNELS]
    _module, cfg, _camera_optimizer = method_parts(method)
    tree, params, _ = make_params(method, dev, num_train_data=20)
    aux = occupancy_state(method, params, dev)
    # no profiled frame: 20-41 k kernels a frame took 11-31 s to profile
    launches[f"render {method}"], _ = render_phase(
        method, params, cams, dev, aabb, trace_dir, aux=aux, profile=False)
    render_cpu_check(method, tree, params, cams, dev, aabb, aux=aux)
    del params
    torch.cuda.empty_cache()
    kernels["scatter_add_rows"] += scatter_step_phase(method, cfg, tree, dev, aux)
    launches[f"train {method}"], in_step = train_phase(
        method, tree, dev, trace_dir, must_launch=scatter, every_step=scatter,
        aux=aux, window=OCC_TRAIN_WINDOW, sub=16)
    for update, (times, _counts) in in_step.items():
        log(f"in-step kernels, {method} ({'update' if update else 'non-update'}"
            f" step): " + ", ".join(f"{k} {v:.3f} ms" for k, v in times.items()))
    scatter_in_step(method, kernels["scatter_add_rows"], in_step)
    train_cpu_check(method, tree, dev, OCC_CPU_SEEDS, witnesses=method == NPNGPC,
                    aux=aux)
    del tree, aux
    torch.cuda.empty_cache()


def classic_method_phases(method, dev, cams, aabb, trace_dir, launches) -> None:
    """A classic method's phases (tensorf, vanilla-nerf, mipnerf), its
    weights seeded as at CLASSIC_STEP (TensoRF's tables at their final
    300^3): render CLASSIC_FRAMES and check a chunk of CLASSIC_CPU_RAYS on
    the CPU; train (the registry's batches) and check a step of
    CLASSIC_CPU_RAYS on the CPU, with the witnesses.  Adds to
    ``launches``."""
    tree, params, _ = make_params(method, dev, step=CLASSIC_STEP)
    counted, steady, profile = CLASSIC_FRAMES[method]
    launches[f"render {method}"], _ = render_phase(
        method, params, cams, dev, aabb, trace_dir, frames=counted,
        steady=steady, profile=profile)
    render_cpu_check(method, tree, params, cams, dev, aabb,
                     n=CLASSIC_CPU_RAYS[method])
    del params
    torch.cuda.empty_cache()
    launches[f"train {method}"], _ = train_phase(method, tree, dev, trace_dir,
                                                 must_launch=())
    train_cpu_check(method, tree, dev, CLASSIC_CPU_SEEDS, witnesses=True,
                    rays=CLASSIC_CPU_RAYS[method])
    del tree
    torch.cuda.empty_cache()


def timed(fn, record, sync=False):
    """``fn`` wrapped so that each call appends its host seconds to
    ``record`` (after a synchronise when ``sync``)."""
    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        if sync:
            torch.cuda.synchronize()
        record.append(time.perf_counter() - t0)
        return out
    return wrapper


def event_sink():
    """A writer sink that keeps every scalar the Trainer logs, as
    (name, step, value)."""
    from soccernerfs_tpu_torch.utils import writer

    class Events(writer.Writer):
        def __init__(self):
            self.scalars = []

        def write_scalar(self, name, scalar, step):
            self.scalars.append((name, step, scalar))

    sink = Events()
    writer._SINKS.append(sink)
    return sink


def trainer_config(method, dataparser, out_dir, name, data=(), loop=()):
    """A copy of ``trainer_configs[method]`` reading ``dataparser``, writing
    under ``out_dir``/…/``name``, with datamanager fields ``data`` and
    trainer fields ``loop`` set."""
    import copy

    from soccernerfs_tpu_torch.configs.method_configs import trainer_configs

    cfg = copy.deepcopy(trainer_configs[method])
    cfg.pipeline.datamanager.dataparser = dataparser
    for key, value in dict(data).items():
        setattr(cfg.pipeline.datamanager, key, value)
    for key, value in dict(loop).items():
        setattr(cfg, key, value)
    cfg.output_dir, cfg.experiment_name, cfg.timestamp = out_dir, method, name
    return cfg


def check_finite_events(sink, tag):
    bad = [(n, s, v) for n, s, v in sink.scalars
           if "Loss" in n and not np.isfinite(v)]
    if bad:
        raise AssertionError(f"{tag}: non-finite losses {bad[:8]}")


def trainer_kplanes_phase(dev, root, launches) -> None:
    """``Trainer.train`` of K-Planes at full width on a broadcaststyle
    fixture at 540x960 (the dynamic data path: the cache refreshing every
    16 steps with IST weights computed on the card, the importance sampler
    drawing IST rays from step 8), 64 steps with eval batches, an eval
    image and checkpoints; then a fresh Trainer resumed from the final
    checkpoint (its state bit-equal) runs to step 96.  Fails unless the
    cache refreshed twice with IST weights, a batch held
    floor(is_pixel_ratio * rays) IST rays, every loss was finite, every
    param group moved and all five plane kernels launched in the loop (the
    fused one by the eval image at step 32)."""
    from soccernerfs_tpu_torch.data.dataparsers import DATAPARSERS
    from soccernerfs_tpu_torch.data.fixtures import make_broadcaststyle_fixture
    from soccernerfs_tpu_torch.engine import checkpoints
    from soccernerfs_tpu_torch.engine.trainer import Trainer
    from soccernerfs_tpu_torch.ops.kernels import plane_kernels as pk
    from soccernerfs_tpu_torch.ops.kernels import scatter_kernels as sk
    from soccernerfs_tpu_torch.utils.tree import tree_leaves

    tag = f"trainer_kplanes {MODEL}"
    t0 = time.perf_counter()
    # the depth maps are for trainer_kplanes_depth: under the parser's
    # default depth_maps="none" this run reads none of them
    data = make_broadcaststyle_fixture(root / "broadcaststyle", with_depth=True,
                                       **TRAINER_FIXTURE)
    fixture_s = time.perf_counter() - t0
    parser = DATAPARSERS["broadcaststyle-data"](data=data, fps_downsample=1.0)
    cfg = trainer_config(MODEL, parser, root / "out", "first", TRAINER_DATA,
                         TRAINER_LOOP)
    cfg.logging.steps_per_log = TRAINER_LOG_STEPS
    dm_cfg = cfg.pipeline.datamanager
    log(json.dumps({"phase": "trainer_kplanes", "method": MODEL,
                    "fixture": {**TRAINER_FIXTURE, "scene": "broadcaststyle",
                                "written_s": fixture_s},
                    "overrides": {**TRAINER_DATA, **TRAINER_LOOP,
                                  "steps_per_log": TRAINER_LOG_STEPS,
                                  "fps_downsample": 1.0,
                                  "resume_to": TRAINER_RESUME_TO},
                    "registered": {"train_num_rays_per_batch":
                                   dm_cfg.train_num_rays_per_batch,
                                   "is_pixel_ratio": dm_cfg.is_pixel_ratio,
                                   "ist_range": dm_cfg.ist_range}}))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = Trainer(cfg, device=dev).setup()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    sink = event_sink()
    dm = trainer.datamanager
    rays = dm.get_train_rays_per_batch()

    # the data path's host time per step, the refreshes apart
    decode_s, is_s, raw = [], [], []
    dm.train_cache._collate = timed(dm.train_cache._collate, decode_s)
    dm.train_dataset.compute_is = timed(dm.train_dataset.compute_is, is_s)
    sampler = dm.train_pixel_sampler
    drawn = [0]
    weighted_choice = sampler._weighted_choice

    def counted_choice(*args):
        out = weighted_choice(*args)
        drawn[0] += len(out)
        return out

    sampler._weighted_choice = counted_choice
    next_train_raw = dm.next_train_raw

    def timed_raw(step):
        n_dec, n_is = len(decode_s), len(is_s)
        drawn[0] = 0
        t = time.perf_counter()
        out = next_train_raw(step)
        refresh = sum(decode_s[n_dec:]) + sum(is_s[n_is:])
        raw.append((step, time.perf_counter() - t - refresh, drawn[0]))
        return out

    dm.next_train_raw = timed_raw
    side_s, eval_psnr, save_s = [], [], []
    trainer.eval_iteration = timed(trainer.eval_iteration, side_s)
    eval_image = trainer.eval_image
    trainer.eval_image = timed(lambda step: eval_psnr.append(eval_image(step)),
                               side_s)
    trainer.save_checkpoint = timed(trainer.save_checkpoint, save_s, sync=True)

    watch = watch_groups(trainer)
    reset_launch_counts()
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches[f"trainer {MODEL}"] = counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    check_finite_events(sink, tag)
    stuck = stuck_groups(trainer, watch)
    if stuck:
        raise AssertionError(f"{tag}: param groups {stuck} did not move")
    missing = [k.__name__ for k in pk.KERNELS if counts[k.__name__] <= 0]
    if missing:
        raise AssertionError(f"{tag}: {missing} not launched in the loop")
    if len(is_s) < 2 or dm.train_cache.cached_batch.get("ist_weights") is None:
        raise AssertionError(f"{tag}: {len(is_s)} cache refreshes with IST "
                             f"weights (at least 2)")
    want_ist = int(dm_cfg.is_pixel_ratio * rays)
    ist_rays = [n for _s, _t, n in raw]
    if want_ist not in ist_rays:
        raise AssertionError(f"{tag}: no batch held {want_ist} IST rays "
                             f"({sorted(set(ist_rays))})")

    loop_s = train_s - sum(side_s) - sum(save_s)
    steps = len(raw)
    TRAINER_KPLANES.update(loop_rays_per_s=rays * steps / loop_s,
                           refresh_decode_ms=[1e3 * t for t in decode_s])
    start_is = dm_cfg.iters_to_start_is
    before_is = [t for s, t, _n in raw if s < start_is]
    after_is = [t for s, t, _n in raw if s >= start_is]
    rolling = [v for n, _s, v in sink.scalars if n == "Train Rays / Sec"]

    # resume: a fresh Trainer from the final checkpoint
    cfg2 = trainer_config(MODEL, parser, root / "out", "resumed", TRAINER_DATA,
                          {**TRAINER_LOOP, "max_num_iterations": TRAINER_RESUME_TO})
    cfg2.logging.steps_per_log = TRAINER_LOG_STEPS
    cfg2.load_dir = trainer.base_dir
    load_s = []
    maybe_load = Trainer._maybe_load_checkpoint
    Trainer._maybe_load_checkpoint = timed(maybe_load, load_s, sync=True)
    try:
        resumed = Trainer(cfg2, device=dev).setup()
    finally:
        Trainer._maybe_load_checkpoint = maybe_load
    a, b = trainer.state, resumed.state
    same = (a.step == b.step and a.steps_since_update == b.steps_since_update
            and all(torch.equal(x, y) for x, y in zip(tree_leaves(a.params),
                                                       tree_leaves(b.params)))
            and all(o.count == b.opt_state[n].count
                    and all(torch.equal(x, y) for x, y in
                            zip(o.mu + o.nu, b.opt_state[n].mu + b.opt_state[n].nu))
                    for n, o in a.opt_state.items())
            and all(torch.equal(a.aux[k], b.aux[k]) for k in a.aux))
    if not same:
        raise AssertionError(f"{tag}: the resumed state differs from the "
                             f"checkpointed one")
    mu_dtypes = sorted({str(m.dtype) for o in b.opt_state.values() for m in o.mu})
    log(f"{tag}: resumed at step {b.step} (steps_since_update "
        f"{b.steps_since_update}): params, opt_state (first moments "
        f"{mu_dtypes}) and aux bit-equal")
    resumed_from = b.step
    del trainer, a
    torch.cuda.empty_cache()
    event_sink_resumed = event_sink()
    reset_launch_counts()
    t0 = time.perf_counter()
    resumed.train()
    torch.cuda.synchronize()
    resumed_s = time.perf_counter() - t0
    launches[f"trainer {MODEL} resumed"] = launch_counts()
    check_finite_events(event_sink_resumed, tag)
    last = checkpoints.latest_checkpoint_step(resumed.base_dir)
    if last != TRAINER_RESUME_TO - 1 or resumed.state.step != TRAINER_RESUME_TO:
        raise AssertionError(f"{tag}: resumed run ended at state step "
                             f"{resumed.state.step}, checkpoint {last}")
    # where a loop step's time goes (IST on): the sampler (a cache refresh
    # in these steps left out), the batch's copy to the card, the train
    # step; each part ends in a synchronise
    split, refresh_s = [], []
    dm = resumed.datamanager
    dm.train_cache._collate = timed(dm.train_cache._collate, refresh_s)
    dm.train_dataset.compute_is = timed(dm.train_dataset.compute_is, refresh_s)
    for step in range(TRAINER_RESUME_TO, TRAINER_RESUME_TO + TRAINER_LOG_STEPS):
        n_refresh = len(refresh_s)
        t0 = time.perf_counter()
        raw_batch = dm.next_train_raw(step)
        t1 = time.perf_counter()
        batch = resumed._device_batch(raw_batch)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        resumed.train_step.train_iteration(resumed.state, batch,
                                           resumed._generator(step))
        torch.cuda.synchronize()
        split.append((t1 - t0 - sum(refresh_s[n_refresh:]), t2 - t1,
                      time.perf_counter() - t2))
    sk.raise_if_out_of_range(dev)
    split_ms = {name: 1e3 * float(np.mean([row[i] for row in split]))
                for i, name in enumerate(("sampler", "device_batch", "train_step"))}
    log(json.dumps({
        "phase": "trainer_kplanes", "method": MODEL, "card": card_line(),
        "setup_s": setup_s, "train_s": train_s, "steps": steps,
        "loop_rays_per_s": rays * steps / loop_s,
        "trainstep_window_rays_per_s": WINDOW_RAYS_PER_S.get(MODEL),
        "rolling_rays_per_s": rolling,
        "sampler_ms_per_step_before_is": 1e3 * float(np.mean(before_is)),
        "sampler_ms_per_step_after_is": 1e3 * float(np.mean(after_is)),
        "sampler_ms_after_is_max": 1e3 * float(np.max(after_is)),
        "refresh_decode_ms": [1e3 * t for t in decode_s],
        "refresh_ist_ms": [1e3 * t for t in is_s],
        "ist_rays_per_batch": sorted(set(ist_rays)),
        "evals_and_image_s": sum(side_s), "eval_image_psnr":
            [r["psnr"] for r in eval_psnr],
        "save_ms": [1e3 * t for t in save_s], "load_ms": 1e3 * load_s[0],
        "resumed_from": resumed_from, "resumed_s": resumed_s,
        "final_checkpoint": last, "split_ms_per_step": split_ms,
        "peak_gib": peak,
        "launches": counts}))
    del resumed, b
    torch.cuda.empty_cache()


def trainer_kplanes_depth_phase(dev, root, launches) -> None:
    """``Trainer.train`` of K-Planes at full width on ``trainer_kplanes``'
    fixture with its depth maps (``depth_maps="depth-maps"``: the masked
    variant's files, 3 m at the parser's 0.01 unit), TRAINER_DEPTH_STEPS
    steps with IST as ``trainer_kplanes`` sets it: each cache refresh
    decodes the depth maps beside the images, and every batch carries
    target depths.  Fails unless ``depth_loss`` is finite, positive and in
    the writer's events at every log step, and all four train plane
    kernels launched in the loop."""
    from soccernerfs_tpu_torch.data.dataparsers import DATAPARSERS
    from soccernerfs_tpu_torch.engine.trainer import Trainer
    from soccernerfs_tpu_torch.ops.kernels import plane_kernels as pk

    tag = f"trainer_kplanes_depth {MODEL}"
    parser = DATAPARSERS["broadcaststyle-data"](
        data=root / "broadcaststyle", fps_downsample=1.0, depth_maps="depth-maps")
    cfg = trainer_config(MODEL, parser, root / "out", "depth", TRAINER_DATA,
                         {**TRAINER_LOOP, "max_num_iterations": TRAINER_DEPTH_STEPS})
    cfg.logging.steps_per_log = TRAINER_LOG_STEPS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = Trainer(cfg, device=dev).setup()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    sink = event_sink()
    dm = trainer.datamanager
    rays = dm.get_train_rays_per_batch()
    decode_s, is_s, side_s, save_s = [], [], [], []
    dm.train_cache._collate = timed(dm.train_cache._collate, decode_s)
    dm.train_dataset.compute_is = timed(dm.train_dataset.compute_is, is_s)
    trainer.eval_iteration = timed(trainer.eval_iteration, side_s)
    trainer.eval_image = timed(trainer.eval_image, side_s)
    trainer.save_checkpoint = timed(trainer.save_checkpoint, save_s, sync=True)
    reset_launch_counts()
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches[f"trainer {MODEL} depth"] = counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    check_finite_events(sink, tag)
    missing = [k.__name__ for k in pk.TRAIN_KERNELS if counts[k.__name__] <= 0]
    if missing:
        raise AssertionError(f"{tag}: {missing} not launched in the loop")
    depth = {step: v for n, step, v in sink.scalars
             if n == "Train Loss Dict/depth_loss"}
    log_steps = list(range(0, TRAINER_DEPTH_STEPS, TRAINER_LOG_STEPS))
    if sorted(depth) != log_steps or not all(
            np.isfinite(v) and v > 0 for v in depth.values()):
        raise AssertionError(f"{tag}: depth_loss at the log steps {log_steps}: "
                             f"{depth}")
    if "depth_image" not in dm.train_cache.cached_batch:
        raise AssertionError(f"{tag}: the cache holds no depth maps")
    loop_s = train_s - sum(side_s) - sum(save_s) - sum(decode_s) - sum(is_s)
    log(json.dumps({
        "phase": "trainer_kplanes_depth", "method": MODEL, "card": card_line(),
        "steps": TRAINER_DEPTH_STEPS, "setup_s": setup_s, "train_s": train_s,
        "loop_rays_per_s": rays * TRAINER_DEPTH_STEPS
        / (train_s - sum(side_s) - sum(save_s)),
        "loop_rays_per_s_without_refreshes": rays * TRAINER_DEPTH_STEPS / loop_s,
        "trainer_kplanes_loop_rays_per_s": TRAINER_KPLANES.get("loop_rays_per_s"),
        "trainstep_window_rays_per_s": WINDOW_RAYS_PER_S.get(MODEL),
        "refresh_decode_ms_with_depth": [1e3 * t for t in decode_s],
        "trainer_kplanes_refresh_decode_ms": TRAINER_KPLANES.get(
            "refresh_decode_ms"),
        "refresh_ist_ms": [1e3 * t for t in is_s],
        "depth_loss": depth, "peak_gib": peak, "launches": counts}))
    del trainer
    torch.cuda.empty_cache()


def trainer_ingp_phase(dev, root, launches) -> None:
    """``Trainer.train`` of instant-ngp-bounded (``dynamic_batch`` on, as
    registered) on the same fixture for 48 steps; prints the rays per batch
    after each bucket change and fails unless scatter_add_rows launched in
    the loop."""
    from soccernerfs_tpu_torch.data.dataparsers import DATAPARSERS
    from soccernerfs_tpu_torch.engine.trainer import Trainer

    tag = f"trainer_ingp_bounded {INGP}"
    parser = DATAPARSERS["broadcaststyle-data"](
        data=root / "broadcaststyle", fps_downsample=1.0)
    cfg = trainer_config(INGP, parser, root / "out", "ingp", (),
                         {"max_num_iterations": INGP_TRAINER_STEPS, "vis": "none"})
    if not cfg.pipeline.dynamic_batch:
        raise AssertionError(f"{tag}: dynamic_batch is off in the registry")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = Trainer(cfg, device=dev).setup()
    setup_s = time.perf_counter() - t0
    sink = event_sink()
    sampler = trainer.datamanager.train_pixel_sampler
    batch_rays, changes = [], []
    train_iteration = trainer.train_iteration

    def counted(step):
        batch_rays.append(sampler.num_rays_per_batch)
        return train_iteration(step)

    trainer.train_iteration = counted
    set_rays = sampler.set_num_rays_per_batch

    def logged_set(n):
        changes.append({"after_step": len(batch_rays) - 1, "rays": n})
        log(f"{tag}: step {len(batch_rays) - 1}: rays per batch "
            f"{sampler.num_rays_per_batch} -> {n}")
        set_rays(n)

    sampler.set_num_rays_per_batch = logged_set
    reset_launch_counts()
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches[f"trainer {INGP}"] = counts = launch_counts()
    check_finite_events(sink, tag)
    if counts["scatter_add_rows"] <= 0:
        raise AssertionError(f"{tag}: scatter_add_rows not launched in the loop")
    log(json.dumps({
        "phase": "trainer_ingp_bounded", "method": INGP, "card": card_line(),
        "setup_s": setup_s, "train_s": train_s, "steps": len(batch_rays),
        "loop_rays_per_s": sum(batch_rays) / train_s,
        "bucket_changes": changes, "final_rays_per_batch": sampler.num_rays_per_batch,
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        "launches": counts}))
    del trainer
    torch.cuda.empty_cache()


def convergence_phase(dev, root, launches) -> None:
    """ROADMAP A.6's gate on the card: k-planes-static on the blender
    fixture through ``Trainer.train`` with tests/test_convergence.py's
    overrides, then ``average_eval_image_metrics``; fails unless the
    held-out PSNR and SSIM pass CONVERGENCE_GATE."""
    from soccernerfs_tpu_torch.data.dataparsers import DATAPARSERS
    from soccernerfs_tpu_torch.data.fixtures import make_blender_fixture
    from soccernerfs_tpu_torch.engine.trainer import Trainer
    from soccernerfs_tpu_torch.pipelines import average_eval_image_metrics

    import dataclasses

    data = make_blender_fixture(root / "blender")
    cfg = trainer_config(STATIC, DATAPARSERS["blender-data"](data=data),
                         root / "out", "static",
                         {"train_num_rays_per_batch": CONVERGENCE_RAYS},
                         {"max_num_iterations": CONVERGENCE_STEPS,
                          "steps_per_save": CONVERGENCE_STEPS, "vis": "none"})
    cfg.pipeline.model = dataclasses.replace(cfg.pipeline.model,
                                             **CONVERGENCE_MODEL)
    t0 = time.perf_counter()
    trainer = Trainer(cfg, device=dev).setup()
    reset_launch_counts()
    trainer.train()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches[f"convergence {STATIC}"] = counts = launch_counts()
    metrics = average_eval_image_metrics(trainer)
    psnr_gate, ssim_gate = CONVERGENCE_GATE
    log(json.dumps({"phase": "convergence_kplanes_static", "method": STATIC,
                    "card": card_line(), "steps": CONVERGENCE_STEPS,
                    "rays": CONVERGENCE_RAYS, "model": CONVERGENCE_MODEL,
                    "psnr": metrics["psnr"], "ssim": metrics["ssim"],
                    "lpips": metrics["lpips"], "gate": CONVERGENCE_GATE,
                    "train_s": train_s, "launches": counts}))
    if not (metrics["psnr"] > psnr_gate and metrics["ssim"] > ssim_gate):
        raise AssertionError(f"convergence {STATIC}: PSNR {metrics['psnr']} "
                             f"SSIM {metrics['ssim']}, the gate is "
                             f"{CONVERGENCE_GATE}")
    del trainer
    torch.cuda.empty_cache()


def trainer_tensorf_phase(dev, root, launches) -> None:
    """``Trainer.train`` of tensorf at registry width on a blender fixture
    (TENSORF_FIXTURE) for TENSORF_TRAINER_STEPS steps, its upsampling steps
    compressed to TENSORF_TRAINER_ITERS (the registry's resolutions, 128 to
    300).  Fails unless the tables grow at each of those steps to the
    schedule's resolution (300 at the last), each upsample rebuilt every
    group's optimizer state (count 0, zero moments), the losses stay
    finite, and the final checkpoint (past the last upsample) reloads
    through ``eval_setup`` with its 300^3 tables and renders an eval
    image equal to the trainer's own render.  Prints each upsample's
    time (host clock, synchronised)."""
    import dataclasses

    from soccernerfs_tpu_torch.data.dataparsers import DATAPARSERS
    from soccernerfs_tpu_torch.data.fixtures import make_blender_fixture
    from soccernerfs_tpu_torch.engine.trainer import Trainer
    from soccernerfs_tpu_torch.utils.eval_utils import eval_setup

    tag = f"trainer_tensorf {TENSORF}"
    t0 = time.perf_counter()
    data = make_blender_fixture(root / "blender_tensorf", **TENSORF_FIXTURE)
    fixture_s = time.perf_counter() - t0
    cfg = trainer_config(TENSORF, DATAPARSERS["blender-data"](data=data),
                         root / "out", "tensorf", (),
                         {"max_num_iterations": TENSORF_TRAINER_STEPS,
                          "vis": "none"})
    cfg.pipeline.model = dataclasses.replace(
        cfg.pipeline.model, upsampling_iters=TENSORF_TRAINER_ITERS)
    schedule = cfg.pipeline.model.upsampling_resolutions()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(cfg, device=dev).setup()
    sink = event_sink()
    module = trainer.model
    host_update = module.host_update
    upsamples = []

    def recorded(model_cfg, state, step, init_opt_state):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new = host_update(model_cfg, state, step, init_opt_state)
        torch.cuda.synchronize()
        if new is not None:
            upsamples.append({
                "step": step, "ms": 1e3 * (time.perf_counter() - t0),
                "resolution": int(new.params["encodings"]["density"]
                                  ["plane_coef"].shape[1]),
                "counts_before": {k: o.count for k, o in state.opt_state.items()},
                "counts_after": {k: o.count for k, o in new.opt_state.items()},
                "moments_zero": all(float(m.abs().max()) == 0.0
                                    for o in new.opt_state.values()
                                    for m in o.mu + o.nu)})
        return new

    module.host_update = recorded
    reset_launch_counts()
    t0 = time.perf_counter()
    try:
        trainer.train()
        torch.cuda.synchronize()
    finally:
        module.host_update = host_update
    train_s = time.perf_counter() - t0
    launches[f"trainer {TENSORF}"] = launch_counts()
    check_finite_events(sink, tag)
    if [u["step"] for u in upsamples] != list(schedule) or [
            u["resolution"] for u in upsamples] != list(schedule.values()):
        raise AssertionError(f"{tag}: upsamples {upsamples}, schedule {schedule}")
    if upsamples[-1]["resolution"] != cfg.pipeline.model.final_resolution:
        raise AssertionError(f"{tag}: the tables ended at "
                             f"{upsamples[-1]['resolution']}")
    for u in upsamples:
        if (set(u["counts_after"].values()) != {0} or not u["moments_zero"]
                or min(u["counts_before"].values()) <= 0):
            raise AssertionError(f"{tag}: the optimizer state was not rebuilt "
                                 f"at step {u['step']}: {u}")
    since = TENSORF_TRAINER_STEPS - TENSORF_TRAINER_ITERS[-1]
    counts = {k: o.count for k, o in trainer.state.opt_state.items()}
    if set(counts.values()) != {since}:
        raise AssertionError(f"{tag}: optimizer counts {counts} at the end, "
                             f"not {since}")
    rays = trainer.datamanager.get_train_rays_per_batch()
    cams = trainer.eval_cameras
    mine = trainer.render_camera(cams, 0)
    config = trainer.base_dir / "config.yml"
    del trainer
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    _, loaded, step = eval_setup(config, device=dev)
    torch.cuda.synchronize()
    setup_ms = 1e3 * (time.perf_counter() - t0)
    res = loaded.state.params["encodings"]["color"]["plane_coef"].shape[1]
    reset_launch_counts()
    theirs = loaded.render_camera(cams, 0)
    if step != TENSORF_TRAINER_STEPS or res != cfg.pipeline.model.final_resolution:
        raise AssertionError(f"{tag}: eval_setup at step {step}, tables {res}")
    for k in mine:
        if not (np.isfinite(theirs[k]).all() and np.array_equal(theirs[k], mine[k])):
            raise AssertionError(f"{tag}: the reloaded snapshot's {k} differs")
    log(json.dumps({
        "phase": "trainer_tensorf", "method": TENSORF, "card": card_line(),
        "fixture": {**TENSORF_FIXTURE, "written_s": fixture_s},
        "steps": TENSORF_TRAINER_STEPS, "upsampling_iters": TENSORF_TRAINER_ITERS,
        "upsamples": upsamples, "train_s": train_s,
        "loop_rays_per_s": rays * TENSORF_TRAINER_STEPS / train_s,
        "final_loss": [v for n, st, v in sink.scalars if n == "Train Loss"][-1:],
        "eval_setup_ms": setup_ms, "eval_image_psnr": loaded.eval_image(0)["psnr"],
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        "launches": launches[f"trainer {TENSORF}"]}))
    del loaded
    torch.cuda.empty_cache()


def trainer_kplanes_hypernerf_phase(dev, root, launches) -> None:
    """``Trainer.train`` of k-planes at registry width with ``bounded``
    false (experiments/hypernerf_kplanes.py's setting: constant near and
    far planes, piecewise spacing, scene contraction) on a HyperNeRF
    capture of HYPERNERF_FIXTURE (two sides, distorted cameras) for
    HYPERNERF_STEPS steps, IST from HYPERNERF_IST_FROM; then one eval
    image.  Fails unless all four plane kernels launched in training and
    the fused one, and no per-plane forward kernel, in the eval image, the
    losses stay finite and the image is finite."""
    import dataclasses

    from soccernerfs_tpu_torch.data.dataparsers import DATAPARSERS
    from soccernerfs_tpu_torch.data.fixtures import make_hypernerf_fixture
    from soccernerfs_tpu_torch.engine.trainer import Trainer
    from soccernerfs_tpu_torch.ops.kernels import plane_kernels as pk

    tag = f"trainer_kplanes_hypernerf {MODEL}"
    t0 = time.perf_counter()
    data = make_hypernerf_fixture(root / "hypernerf", **HYPERNERF_FIXTURE)
    fixture_s = time.perf_counter() - t0
    cfg = trainer_config(MODEL, DATAPARSERS["hypernerf-data"](data=data),
                         root / "out", "kplanes_hypernerf",
                         {"iters_to_start_is": HYPERNERF_IST_FROM},
                         {"max_num_iterations": HYPERNERF_STEPS, "vis": "none"})
    cfg.pipeline.model = dataclasses.replace(cfg.pipeline.model, bounded=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = Trainer(cfg, device=dev).setup()
    setup_s = time.perf_counter() - t0
    sink = event_sink()
    reset_launch_counts()
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches[f"trainer {MODEL} hypernerf"] = counts = launch_counts()
    check_finite_events(sink, tag)
    missing = [k.__name__ for k in pk.TRAIN_KERNELS if counts[k.__name__] <= 0]
    if missing:
        raise AssertionError(f"{tag}: {missing} not launched in training")
    reset_launch_counts()
    t0 = time.perf_counter()
    image = trainer.eval_image(HYPERNERF_STEPS)
    torch.cuda.synchronize()
    image_s = time.perf_counter() - t0
    launches[f"eval image {MODEL} hypernerf"] = counts = launch_counts()
    if (counts["kplanes_fwd_fused"] <= 0 or any(counts[k] for k in FORWARD)
            or not np.isfinite(image["psnr"])):
        raise AssertionError(f"{tag}: eval image {image}, launches {counts}")
    cams = trainer.train_cameras
    rays = trainer.datamanager.get_train_rays_per_batch()
    log(json.dumps({
        "phase": "trainer_kplanes_hypernerf", "method": MODEL,
        "card": card_line(), "bounded": False,
        "fixture": {**HYPERNERF_FIXTURE, "written_s": fixture_s},
        "train_images": len(trainer.datamanager.train_dataset),
        "distortion_max": float(cams.distortion_params.abs().max()),
        "setup_s": setup_s, "steps": HYPERNERF_STEPS, "train_s": train_s,
        "loop_rays_per_s": rays * HYPERNERF_STEPS / train_s,
        "losses": {str(st): v for n, st, v in sink.scalars if n == "Train Loss"},
        "eval_image": {"psnr": image["psnr"], "s": image_s},
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        "launches": {k: launches[f"{k} {MODEL} hypernerf"]
                     for k in ("trainer", "eval image")}}))
    del trainer
    torch.cuda.empty_cache()


def ball_boxes(data: Path) -> dict:
    """DynMetric's sidecar boxes for the fixture's eval camera (Camera_20):
    per image, the box of its ball's pixels (red), at least BALL_BOX_MIN
    px a side, labelled a ball (37)."""
    from PIL import Image

    table = {}
    for path in sorted(data.glob("images/*/Camera_20_*.png")):
        img = np.asarray(Image.open(path))
        ys, xs = np.nonzero((img[..., 0] > 128) & (img[..., 1] < 100))
        if len(xs) == 0:
            continue
        cx, cy = (xs.min() + xs.max() + 1) / 2, (ys.min() + ys.max() + 1) / 2
        half_w = max(xs.max() + 1 - xs.min(), BALL_BOX_MIN) / 2
        half_h = max(ys.max() + 1 - ys.min(), BALL_BOX_MIN) / 2
        table[path.name] = [{"box": [float(cx - half_w), float(cy - half_h),
                                     float(cx + half_w), float(cy + half_h)],
                             "label": 37}]
    return table


def post(url, payload) -> bytes:
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"},
                                 method="POST")
    with urllib.request.urlopen(req, timeout=300) as reply:
        return reply.read()


def cli_phase(dev, root, launches) -> None:
    """The user entry points on a trained K-Planes snapshot, in process so
    that the launch counters see every kernel: ``scripts.train.main``
    trains k-planes at registry width from a command line (the
    ``trainer_kplanes`` fixture and data overrides as flags, CLI_STEPS
    steps, one checkpoint); ``scripts.eval.main`` writes ns-eval's JSON
    with DynMetric's boxes from a sidecar file (one around the ball per
    eval image); the viewer's server (``viewer.server.make_server`` on
    port 0 of 127.0.0.1) answers /scene, rgb and depth /render requests
    at VIEWER_SIZES, three /keyframe and an /export_path;
    ``scripts.render.main`` renders a spiral (rgb, depth and accumulation
    side by side), an interpolated path and the exported camera_path.json
    as PNG frames.  Fails unless all four train plane kernels launched in
    training and the fused one, and no per-plane forward kernel, in eval,
    in the viewer's /render requests and in render, the checkpoint and
    config exist, psnr, dpsnr and dssim are finite, and every frame and
    PNG has its size."""
    import io
    import threading
    import urllib.request

    from PIL import Image

    from soccernerfs_tpu_torch.core.camera_paths import get_spiral_path
    from soccernerfs_tpu_torch.engine import checkpoints
    from soccernerfs_tpu_torch.engine.trainer import Trainer
    from soccernerfs_tpu_torch.ops.kernels import plane_kernels as pk
    from soccernerfs_tpu_torch.scripts import eval as eval_script
    from soccernerfs_tpu_torch.scripts import render as render_script
    from soccernerfs_tpu_torch.scripts import train as train_script
    from soccernerfs_tpu_torch.utils import eval_utils
    from soccernerfs_tpu_torch.viewer.server import make_server

    tag = f"cli_kplanes {MODEL}"
    render = (pk.kplanes_fwd_fused.__name__,)

    def require(path, names, none=()):
        missing = [n for n in names if launches[path][n] <= 0]
        if missing:
            raise AssertionError(f"{tag}: {missing} not launched in {path!r}")
        extra = [n for n in none if launches[path][n] != 0]
        if extra:
            raise AssertionError(f"{tag}: {extra} launched in {path!r}")

    data = root / "broadcaststyle"
    out = root / "cli"
    argv = [MODEL, "--max-num-iterations", str(CLI_STEPS),
            "--steps-per-save", str(CLI_STEPS), "--vis", "none",
            "--output-dir", str(out)]
    for key, value in TRAINER_DATA.items():
        argv += [f"--pipeline.datamanager.{key.replace('_', '-')}", str(value)]
    argv += ["broadcaststyle-data", "--fps-downsample", "1", "--data", str(data)]
    log(f"{tag}: snt-train {' '.join(argv)}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # snt-train: the loop's time without the checkpoint's save
    loop_s, save_s = [], []
    train, save = Trainer.train, Trainer.save_checkpoint
    Trainer.train = timed(train, loop_s, sync=True)
    Trainer.save_checkpoint = timed(save, save_s, sync=True)
    reset_launch_counts()
    try:
        trainer = train_script.main(argv, device=dev)
    finally:
        Trainer.train, Trainer.save_checkpoint = train, save
    launches[f"cli train {MODEL}"] = launch_counts()
    require(f"cli train {MODEL}", [k.__name__ for k in pk.TRAIN_KERNELS])
    rays = trainer.datamanager.get_train_rays_per_batch()
    run_dir = trainer.base_dir
    config = run_dir / "config.yml"
    if not config.is_file() or not checkpoints.checkpoint_path(
            run_dir, CLI_STEPS - 1).is_file():
        raise AssertionError(f"{tag}: no config.yml or step-{CLI_STEPS - 1} "
                             f"checkpoint under {run_dir}")
    del trainer
    torch.cuda.empty_cache()

    # every eval_setup (the checkpoint's load included) by entry point
    setup_ms = []

    def timed_setup(*args, **kwargs):
        t0 = time.perf_counter()
        result = eval_utils.eval_setup(*args, **kwargs)
        torch.cuda.synchronize()
        setup_ms.append(1e3 * (time.perf_counter() - t0))
        return result

    # snt-eval with DynMetric's boxes
    boxes = root / "cli_boxes.json"
    boxes.write_text(json.dumps(ball_boxes(data)))
    saved_env = os.environ.get("SNT_DYNMETRIC_BOXES")
    os.environ["SNT_DYNMETRIC_BOXES"] = str(boxes)
    eval_script.eval_setup = timed_setup
    reset_launch_counts()
    try:
        info = eval_script.main(["--load-config", str(config), "--output-path",
                                 str(root / "cli_eval.json")], device=dev)
    finally:
        eval_script.eval_setup = eval_utils.eval_setup
        if saved_env is None:
            del os.environ["SNT_DYNMETRIC_BOXES"]
        else:
            os.environ["SNT_DYNMETRIC_BOXES"] = saved_env
    launches[f"cli eval {MODEL}"] = launch_counts()
    require(f"cli eval {MODEL}", render, FORWARD)
    results = info["results"]
    if not ({"experiment_name", "method_name", "checkpoint", "results"} <= set(info)
            and all(results.get(k) is not None and np.isfinite(results[k])
                    for k in ("psnr", "ssim", "dpsnr", "dssim"))):
        raise AssertionError(f"{tag}: eval JSON {info}")
    torch.cuda.empty_cache()

    # the viewer's server on a thread
    _, trainer, _ = timed_setup(config, "inference", device=dev)
    server = make_server(trainer, "127.0.0.1", 0, output_dir=run_dir)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        with urllib.request.urlopen(f"{url}/scene", timeout=60) as reply:
            scene = json.loads(reply.read())
        if scene["num_cameras"] != len(trainer.datamanager.train_dataset):
            raise AssertionError(f"{tag}: /scene {scene}")
        cams = trainer.eval_cameras
        c2w = cams.camera_to_worlds[0].tolist()
        fov = float(np.rad2deg(2 * np.arctan(float(cams.height[0]) / 2
                                             / float(cams.fy[0]))))
        render_ms = []
        reset_launch_counts()
        for width, height in VIEWER_SIZES:
            for output in ("rgb", "depth"):
                t0 = time.perf_counter()
                png = post(f"{url}/render", {"c2w": c2w, "fov": fov,
                                              "width": width, "height": height,
                                              "time": 0.5, "output": output})
                render_ms.append((f"{width}x{height}", output,
                                  1e3 * (time.perf_counter() - t0)))
                size = Image.open(io.BytesIO(png)).size
                if size != (width, height):
                    raise AssertionError(f"{tag}: /render {output} at "
                                         f"{width}x{height} gave {size}")
        launches[f"viewer {MODEL}"] = launch_counts()
        require(f"viewer {MODEL}", render, FORWARD)
        path = get_spiral_path(cams, steps=6)
        for i, t in zip((0, 2, 4), (0.0, 0.5, 1.0)):
            post(f"{url}/keyframe", {"c2w": path.camera_to_worlds[i].tolist(),
                                     "fov": fov, "time": t})
        width, height = VIEWER_SIZES[-1]
        exported = json.loads(post(f"{url}/export_path", {
            "width": width, "height": height,
            "steps_per_transition": CLI_PATH_STEPS, "fps": 24}))
    finally:
        server.shutdown()
        server.server_close()
        thread.join()
    camera_path = Path(exported["path"])
    if len(exported["camera_path"]) != 2 * CLI_PATH_STEPS + 1 \
            or not camera_path.is_file():
        raise AssertionError(f"{tag}: /export_path wrote "
                             f"{len(exported['camera_path'])} frames to "
                             f"{camera_path}")
    del trainer, server
    torch.cuda.empty_cache()

    # snt-render: the spiral, the interpolated path, the exported path
    h, w = int(cams.height[0]), int(cams.width[0])
    trajectories = {
        "spiral": (["--traj", "spiral", "--rendered-output-names", "rgb",
                    "depth", "accumulation"], CLI_RENDER_STEPS, (3 * w, h)),
        "interpolate": (["--traj", "interpolate"],
                        max(CLI_RENDER_STEPS // (cams.num_cameras - 1), 1)
                        * (cams.num_cameras - 1), (w, h)),
        "filename": (["--traj", "filename", "--camera-path-filename",
                      str(camera_path)], 2 * CLI_PATH_STEPS + 1,
                     VIEWER_SIZES[-1]),
    }
    s_per_frame = {}
    render_script.eval_setup = timed_setup
    reset_launch_counts()
    try:
        for name, (args, frames, size) in trajectories.items():
            n_setup = len(setup_ms)
            t0 = time.perf_counter()
            written = render_script.main(
                ["--load-config", str(config), "--interpolation-steps",
                 str(CLI_RENDER_STEPS), "--output-format", "images",
                 "--output-path", str(root / "cli_render" / f"{name}.mp4"),
                 *args], device=dev)
            s_per_frame[name] = ((time.perf_counter() - t0 - 1e-3 * sum(
                setup_ms[n_setup:])) / frames)
            pngs = sorted(written.glob("*.png"))
            sizes = {Image.open(p).size for p in pngs}
            if len(pngs) != frames or sizes != {size}:
                raise AssertionError(f"{tag}: render {name}: {len(pngs)} "
                                     f"frames of {sizes}, expected {frames} "
                                     f"of {size}")
            torch.cuda.empty_cache()
    finally:
        render_script.eval_setup = eval_utils.eval_setup
    launches[f"cli render {MODEL}"] = launch_counts()
    require(f"cli render {MODEL}", render, FORWARD)

    first = render_ms[0]
    by_size = {}
    for size, _output, ms in render_ms[1:]:
        by_size.setdefault(size, []).append(ms)
    log(json.dumps({
        "phase": "cli_kplanes", "method": MODEL, "card": card_line(),
        "train_argv": argv, "train_steps": CLI_STEPS,
        "train_loop_rays_per_s": rays * CLI_STEPS / (loop_s[0] - sum(save_s)),
        "train_loop_s": loop_s[0], "save_ms": [1e3 * t for t in save_s],
        "eval": {k: results[k] for k in ("psnr", "ssim", "lpips", "dpsnr",
                                         "dssim", "dlpips", "num_rays_per_sec",
                                         "fps")},
        "eval_images_with_a_box": len(json.loads(boxes.read_text())),
        "render_s_per_frame": s_per_frame,
        "render_frames": {k: v[1] for k, v in trajectories.items()},
        "viewer_first_render_ms": {f"{first[0]} {first[1]}": first[2]},
        "viewer_render_ms": by_size,
        "eval_setup_ms": setup_ms,
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        "launches": {k: launches[f"{k} {MODEL}"]
                     for k in ("cli train", "cli eval", "viewer", "cli render")}}))


def cli_depth_phase(dev, root, launches) -> None:
    """The nerfacto family through the user entry points: ``snt-train
    depth-nerfacto ... nerfstudio-data`` at registry width on a
    nerfstudio-format ring (NERFSTUDIO_FIXTURE, with z-depth maps in
    millimetres) for CLI_STEPS steps with its registered live viewer on a
    free port (``--viewer.websocket-port 0``), which answers one /render
    at VIEWER_SIZES[0] while the trainer lives and is then shut down;
    ``snt-eval`` over the eval split; ``snt-render`` over a spiral of PNG
    frames.  Fails unless scatter_add_rows launched 3 times per training
    step that updates the proposals and once per other step,
    ``depth_loss`` was finite and positive at every log step, psnr and
    ssim are finite and every frame has its size."""
    import io

    from PIL import Image

    from soccernerfs_tpu_torch.data.fixtures import make_nerfstudio_fixture
    from soccernerfs_tpu_torch.engine.trainer import Trainer
    from soccernerfs_tpu_torch.scripts import eval as eval_script
    from soccernerfs_tpu_torch.scripts import render as render_script
    from soccernerfs_tpu_torch.scripts import train as train_script
    from soccernerfs_tpu_torch.utils import eval_utils, writer

    tag = f"cli_depth_nerfacto {DEPTH}"
    t0 = time.perf_counter()
    data = make_nerfstudio_fixture(root / "nerfstudio", **NERFSTUDIO_FIXTURE)
    fixture_s = time.perf_counter() - t0
    out = root / "cli_depth"
    argv = [DEPTH, "--max-num-iterations", str(CLI_STEPS), "--steps-per-save",
            str(CLI_STEPS), "--viewer.websocket-port", "0",
            "--output-dir", str(out),
            "nerfstudio-data", "--data", str(data)]
    log(f"{tag}: snt-train {' '.join(argv)}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # snt-train, its events kept, the loop timed without the save
    sink = event_sink()
    setup_writers = writer.setup_writers

    def with_sink(*args, **kwargs):
        setup_writers(*args, **kwargs)
        writer._SINKS.append(sink)

    loop_s, save_s = [], []
    train, save = Trainer.train, Trainer.save_checkpoint
    Trainer.train = timed(train, loop_s, sync=True)
    Trainer.save_checkpoint = timed(save, save_s, sync=True)
    writer.setup_writers = with_sink
    reset_launch_counts()
    try:
        trainer = train_script.main(argv, device=dev)
    finally:
        Trainer.train, Trainer.save_checkpoint = train, save
        writer.setup_writers = setup_writers
    launches[f"cli train {DEPTH}"] = counts = launch_counts()
    # 3 launches per proposal-update step, 1 per other step
    updates = proposal_updates(DEPTH, CLI_STEPS)
    if counts["scatter_add_rows"] != 3 * updates + (CLI_STEPS - updates):
        raise AssertionError(f"{tag}: scatter_add_rows launched "
                             f"{counts['scatter_add_rows']} times in {updates} "
                             f"update and {CLI_STEPS - updates} other steps")
    check_finite_events(sink, tag)
    depth = {step: v for n, step, v in sink.scalars
             if n == "Train Loss Dict/depth_loss"}
    log_steps = list(range(0, CLI_STEPS, trainer.config.logging.steps_per_log))
    if sorted(depth) != log_steps or not all(
            np.isfinite(v) and v > 0 for v in depth.values()):
        raise AssertionError(f"{tag}: depth_loss at the log steps {log_steps}: "
                             f"{depth}")
    rays = trainer.datamanager.get_train_rays_per_batch()

    # the live viewer, while the trainer lives
    server = trainer.viewer_server
    if server is None:
        raise AssertionError(f"{tag}: vis {trainer.config.vis!r} started no viewer")
    cams = trainer.eval_cameras
    width, height = VIEWER_SIZES[0]
    fov = float(np.rad2deg(2 * np.arctan(float(cams.height[0]) / 2
                                         / float(cams.fy[0]))))
    try:
        live_ms = []
        reset_launch_counts()
        for _ in range(2):
            t0 = time.perf_counter()
            png = post(f"http://127.0.0.1:{server.server_address[1]}/render",
                       {"c2w": cams.camera_to_worlds[0].tolist(), "fov": fov,
                        "width": width, "height": height})
            live_ms.append(1e3 * (time.perf_counter() - t0))
            size = Image.open(io.BytesIO(png)).size
            if size != (width, height):
                raise AssertionError(f"{tag}: live /render gave {size}")
        launches[f"live viewer {DEPTH}"] = launch_counts()
    finally:
        server.shutdown()
        server.server_close()
    config = trainer.base_dir / "config.yml"
    del trainer, server
    torch.cuda.empty_cache()

    setup_ms = []

    def timed_setup(*args, **kwargs):
        t0 = time.perf_counter()
        result = eval_utils.eval_setup(*args, **kwargs)
        torch.cuda.synchronize()
        setup_ms.append(1e3 * (time.perf_counter() - t0))
        return result

    eval_script.eval_setup = render_script.eval_setup = timed_setup
    try:
        reset_launch_counts()
        info = eval_script.main(["--load-config", str(config), "--output-path",
                                 str(root / "cli_depth_eval.json")], device=dev)
        launches[f"cli eval {DEPTH}"] = launch_counts()
        results = info["results"]
        if not all(np.isfinite(results[k]) for k in ("psnr", "ssim")):
            raise AssertionError(f"{tag}: eval JSON {info}")
        torch.cuda.empty_cache()
        reset_launch_counts()
        t0 = time.perf_counter()
        written = render_script.main(
            ["--load-config", str(config), "--traj", "spiral",
             "--interpolation-steps", str(CLI_RENDER_STEPS), "--output-format",
             "images", "--output-path", str(root / "cli_depth_render" / "s.mp4")],
            device=dev)
        s_per_frame = (time.perf_counter() - t0 - 1e-3 * setup_ms[-1]) / CLI_RENDER_STEPS
        launches[f"cli render {DEPTH}"] = launch_counts()
    finally:
        eval_script.eval_setup = render_script.eval_setup = eval_utils.eval_setup
    pngs = sorted(written.glob("*.png"))
    sizes = {Image.open(f).size for f in pngs}
    want = (int(cams.width[0]), int(cams.height[0]))
    if len(pngs) != CLI_RENDER_STEPS or sizes != {want}:
        raise AssertionError(f"{tag}: render: {len(pngs)} frames of {sizes}")
    log(json.dumps({
        "phase": "cli_depth_nerfacto", "method": DEPTH, "card": card_line(),
        "fixture": {**NERFSTUDIO_FIXTURE, "written_s": fixture_s},
        "train_argv": argv, "train_steps": CLI_STEPS,
        "train_loop_rays_per_s": rays * CLI_STEPS / (loop_s[0] - sum(save_s)),
        "train_loop_s": loop_s[0], "save_ms": [1e3 * t for t in save_s],
        "depth_loss": depth,
        "live_viewer_render_ms": {f"{width}x{height}": live_ms},
        "eval": {k: results[k] for k in ("psnr", "ssim", "num_rays_per_sec",
                                         "fps")},
        "render_s_per_frame": s_per_frame, "render_frames": len(pngs),
        "eval_setup_ms": setup_ms,
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        "launches": {k: launches[f"{k} {DEPTH}"]
                     for k in ("cli train", "live viewer", "cli eval",
                               "cli render")}}))


def cli_ingp_phase(dev, root, launches) -> None:
    """An occupancy method through the user entry points: ``snt-train
    instant-ngp-bounded`` at registry width on the Trainer phases'
    broadcaststyle fixture for CLI_STEPS steps with its registered live
    viewer on a free port, which answers a /render at VIEWER_SIZES[0]
    mid-run; the trainer's own render of an eval camera, then
    ``eval_setup``'s of the snapshot, which must hold the grid exactly and
    render the same image; ``snt-eval``; an 8-frame ``snt-render`` spiral;
    the viewer's /render at VIEWER_SIZES on the snapshot.  Fails unless
    scatter_add_rows launched on every training step."""
    import io
    import threading

    from PIL import Image

    from soccernerfs_tpu_torch.engine.trainer import Trainer
    from soccernerfs_tpu_torch.scripts import eval as eval_script
    from soccernerfs_tpu_torch.scripts import render as render_script
    from soccernerfs_tpu_torch.scripts import train as train_script
    from soccernerfs_tpu_torch.utils import eval_utils, writer
    from soccernerfs_tpu_torch.viewer.server import make_server

    tag = f"cli_ingp_bounded {INGP}"
    data = root / "broadcaststyle"
    out = root / "cli_ingp"
    argv = [INGP, "--max-num-iterations", str(CLI_STEPS), "--steps-per-save",
            str(CLI_STEPS), "--viewer.websocket-port", "0",
            "--output-dir", str(out),
            "broadcaststyle-data", "--fps-downsample", "1", "--data", str(data)]
    log(f"{tag}: snt-train {' '.join(argv)}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sink = event_sink()
    setup_writers = writer.setup_writers

    def with_sink(*args, **kwargs):
        setup_writers(*args, **kwargs)
        writer._SINKS.append(sink)

    def view(port, cams, size, output="rgb"):
        """One /render of eval camera 0 at ``size``: its client ms."""
        width, height = size
        fov = float(np.rad2deg(2 * np.arctan(float(cams.height[0]) / 2
                                             / float(cams.fy[0]))))
        t0 = time.perf_counter()
        png = post(f"http://127.0.0.1:{port}/render",
                   {"c2w": cams.camera_to_worlds[0].tolist(), "fov": fov,
                    "width": width, "height": height, "time": 0.5,
                    "output": output})
        ms = 1e3 * (time.perf_counter() - t0)
        got = Image.open(io.BytesIO(png)).size
        if got != (width, height):
            raise AssertionError(f"{tag}: /render at {size} gave {got}")
        return ms

    live_ms, loop_s, save_s = [], [], []
    iteration = Trainer.train_iteration

    def with_live_request(self, step):
        if step == CLI_STEPS // 2 and self.viewer_server is not None:
            live_ms.append(view(self.viewer_server.server_address[1],
                                self.eval_cameras, VIEWER_SIZES[0]))
        return iteration(self, step)

    train, save = Trainer.train, Trainer.save_checkpoint
    Trainer.train = timed(train, loop_s, sync=True)
    Trainer.save_checkpoint = timed(save, save_s, sync=True)
    Trainer.train_iteration = with_live_request
    writer.setup_writers = with_sink
    reset_launch_counts()
    try:
        trainer = train_script.main(argv, device=dev)
    finally:
        Trainer.train, Trainer.save_checkpoint = train, save
        Trainer.train_iteration = iteration
        writer.setup_writers = setup_writers
    launches[f"cli train {INGP}"] = counts = launch_counts()
    check_finite_events(sink, tag)
    if counts["scatter_add_rows"] < CLI_STEPS or len(live_ms) != 1:
        raise AssertionError(f"{tag}: scatter_add_rows launched "
                             f"{counts['scatter_add_rows']} times in {CLI_STEPS} "
                             f"steps; {len(live_ms)} live /render")
    server = trainer.viewer_server
    server.shutdown()
    server.server_close()
    # the trainer's own render of the state it saved, then the snapshot's
    cams = trainer.eval_cameras
    reset_launch_counts()
    t0 = time.perf_counter()
    mine = trainer.render_camera(cams, 0)
    torch.cuda.synchronize()
    frame_s = time.perf_counter() - t0
    occs = trainer.state.aux["occs"]
    occupied = float(trainer.model.eval_kwargs(
        trainer.model_cfg, trainer.state.aux)["occ_binary"].float().mean())
    config = trainer.base_dir / "config.yml"
    rays = trainer.datamanager.get_train_rays_per_batch()
    del trainer, server
    torch.cuda.empty_cache()
    setup_ms = []

    def timed_setup(*args, **kwargs):
        t0 = time.perf_counter()
        result = eval_utils.eval_setup(*args, **kwargs)
        torch.cuda.synchronize()
        setup_ms.append(1e3 * (time.perf_counter() - t0))
        return result

    _, loaded, _ = timed_setup(config, "inference", device=dev)
    got = loaded.state.aux["occs"]
    if not (got.dtype == occs.dtype and got.device == occs.device
            and torch.equal(got, occs)):
        raise AssertionError(f"{tag}: eval_setup's grid differs from the "
                             f"trained one")
    theirs = loaded.render_camera(cams, 0)
    for k in mine:
        if not np.array_equal(theirs[k], mine[k]):
            raise AssertionError(f"{tag}: the snapshot's {k} differs from the "
                                 f"trainer's render")
    launches[f"cli renders {INGP}"] = launch_counts()
    # the viewer on the snapshot
    server = make_server(loaded, "127.0.0.1", 0, output_dir=config.parent)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    viewer_ms = {}
    try:
        reset_launch_counts()
        for size in VIEWER_SIZES:
            viewer_ms[f"{size[0]}x{size[1]}"] = [
                view(server.server_address[1], cams, size) for _ in range(2)]
        launches[f"viewer {INGP}"] = launch_counts()
    finally:
        server.shutdown()
        server.server_close()
        thread.join()
    del loaded, server
    torch.cuda.empty_cache()
    eval_script.eval_setup = render_script.eval_setup = timed_setup
    try:
        reset_launch_counts()
        info = eval_script.main(["--load-config", str(config), "--output-path",
                                 str(root / "cli_ingp_eval.json")], device=dev)
        launches[f"cli eval {INGP}"] = launch_counts()
        results = info["results"]
        if not all(np.isfinite(results[k]) for k in ("psnr", "ssim")):
            raise AssertionError(f"{tag}: eval JSON {info}")
        torch.cuda.empty_cache()
        reset_launch_counts()
        t0 = time.perf_counter()
        written = render_script.main(
            ["--load-config", str(config), "--traj", "spiral",
             "--interpolation-steps", str(CLI_RENDER_STEPS), "--output-format",
             "images", "--output-path", str(root / "cli_ingp_render" / "s.mp4")],
            device=dev)
        s_per_frame = (time.perf_counter() - t0 - 1e-3 * setup_ms[-1]) / CLI_RENDER_STEPS
        launches[f"cli render {INGP}"] = launch_counts()
    finally:
        eval_script.eval_setup = render_script.eval_setup = eval_utils.eval_setup
    pngs = sorted(written.glob("*.png"))
    sizes = {Image.open(f).size for f in pngs}
    if len(pngs) != CLI_RENDER_STEPS or sizes != {(int(cams.width[0]),
                                                   int(cams.height[0]))}:
        raise AssertionError(f"{tag}: render: {len(pngs)} frames of {sizes}")
    log(json.dumps({
        "phase": "cli_ingp_bounded", "method": INGP, "card": card_line(),
        "train_argv": argv, "train_steps": CLI_STEPS,
        "train_loop_rays_per_s": rays * CLI_STEPS / (loop_s[0] - sum(save_s)),
        "train_loop_s": loop_s[0], "save_ms": [1e3 * t for t in save_s],
        "live_viewer_render_ms": {f"{VIEWER_SIZES[0][0]}x{VIEWER_SIZES[0][1]}":
                                  live_ms},
        "trainer_frame_s": frame_s, "grid_occupied": occupied,
        "snapshot_equals_trainer_render": True,
        "viewer_render_ms": viewer_ms,
        "eval": {k: results[k] for k in ("psnr", "ssim", "num_rays_per_sec",
                                         "fps")},
        "render_s_per_frame": s_per_frame, "render_frames": len(pngs),
        "eval_setup_ms": setup_ms,
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        "launches": {k: launches[f"{k} {INGP}"]
                     for k in ("cli train", "cli renders", "viewer", "cli eval",
                               "cli render")}}))


def cli_dnerf_phase(dev, root, launches) -> None:
    """dnerf through the user entry points: ``snt-train dnerf ...
    dnerf-data`` at registry width on a D-NeRF layout (the blender fixture
    with per-frame times, DNERF_FIXTURE) for DNERF_STEPS steps; ``snt-eval``
    over its test split; a DNERF_RENDER_STEPS-frame ``snt-render`` spiral.
    Fails unless the cameras carry the times, the losses are finite, psnr
    and ssim are finite and every frame has its size."""
    from PIL import Image

    from soccernerfs_tpu_torch.data.fixtures import make_blender_fixture
    from soccernerfs_tpu_torch.engine.trainer import Trainer
    from soccernerfs_tpu_torch.scripts import eval as eval_script
    from soccernerfs_tpu_torch.scripts import render as render_script
    from soccernerfs_tpu_torch.scripts import train as train_script
    from soccernerfs_tpu_torch.utils import writer

    tag = f"cli_dnerf {DNERF}"
    t0 = time.perf_counter()
    data = make_blender_fixture(root / "dnerf", with_times=True, **DNERF_FIXTURE)
    fixture_s = time.perf_counter() - t0
    argv = [DNERF, "--max-num-iterations", str(DNERF_STEPS), "--steps-per-save",
            str(DNERF_STEPS), "--vis", "none", "--output-dir",
            str(root / "cli_dnerf"), "dnerf-data", "--data", str(data)]
    log(f"{tag}: snt-train {' '.join(argv)}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sink = event_sink()
    setup_writers = writer.setup_writers

    def with_sink(*args, **kwargs):
        setup_writers(*args, **kwargs)
        writer._SINKS.append(sink)

    loop_s, save_s = [], []
    train, save = Trainer.train, Trainer.save_checkpoint
    Trainer.train = timed(train, loop_s, sync=True)
    Trainer.save_checkpoint = timed(save, save_s, sync=True)
    writer.setup_writers = with_sink
    try:
        trainer = train_script.main(argv, device=dev)
    finally:
        Trainer.train, Trainer.save_checkpoint = train, save
        writer.setup_writers = setup_writers
    check_finite_events(sink, tag)
    if not [n for n, _st, _v in sink.scalars if n == "Train Loss"]:
        raise AssertionError(f"{tag}: no loss was logged")
    times = trainer.train_cameras.times
    if times is None or float(times.max()) != 1.0:
        raise AssertionError(f"{tag}: the cameras' times are {times}")
    rays = trainer.datamanager.get_train_rays_per_batch()
    config = trainer.base_dir / "config.yml"
    cams = trainer.eval_cameras
    del trainer
    torch.cuda.empty_cache()
    info = eval_script.main(["--load-config", str(config), "--output-path",
                             str(root / "cli_dnerf_eval.json")], device=dev)
    results = info["results"]
    if not all(np.isfinite(results[k]) for k in ("psnr", "ssim")):
        raise AssertionError(f"{tag}: eval JSON {info}")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    written = render_script.main(
        ["--load-config", str(config), "--traj", "spiral",
         "--interpolation-steps", str(DNERF_RENDER_STEPS), "--output-format",
         "images", "--output-path", str(root / "cli_dnerf_render" / "s.mp4")],
        device=dev)
    render_s = time.perf_counter() - t0
    pngs = sorted(written.glob("*.png"))
    sizes = {Image.open(f).size for f in pngs}
    if len(pngs) != DNERF_RENDER_STEPS or sizes != {(int(cams.width[0]),
                                                     int(cams.height[0]))}:
        raise AssertionError(f"{tag}: render: {len(pngs)} frames of {sizes}")
    log(json.dumps({
        "phase": "cli_dnerf", "method": DNERF, "card": card_line(),
        "fixture": {**DNERF_FIXTURE, "written_s": fixture_s},
        "train_argv": argv, "train_steps": DNERF_STEPS,
        "train_loop_rays_per_s": rays * DNERF_STEPS / (loop_s[0] - sum(save_s)),
        "train_loop_s": loop_s[0],
        "losses": {str(st): v for n, st, v in sink.scalars if n == "Train Loss"},
        "eval": {k: results[k] for k in ("psnr", "ssim", "num_rays_per_sec",
                                         "fps")},
        "render_s": render_s, "render_frames": len(pngs),
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30}))


def semantic_method_phases(dev, cams, aabb, trace_dir, kernels, launches) -> None:
    """semantic-nerfw's phases: render (two counted frames, two timed, one
    profiled: nerfacto's forward and the semantic head's 100 classes at
    chunk 2^16) and check a chunk on the CPU, the composited logits
    beside rgb; the scatter's launches of a train step; train (4096-ray
    batches with random labels of the 100 classes) and check a 1024-ray
    step on the CPU.  The head reads detached geo features, so
    scatter_add_rows must launch as for nerfacto: 3 times per update step,
    once per other step.  Adds to ``kernels`` and ``launches``."""
    from soccernerfs_tpu_torch.ops.kernels import scatter_kernels as sk

    scatter = [k.__name__ for k in sk.KERNELS]
    _module, cfg, _camera_optimizer = method_parts(SEMANTIC)
    tree, params, _ = make_params(SEMANTIC, dev, num_train_data=20)
    launches[f"render {SEMANTIC}"], _ = render_phase(
        SEMANTIC, params, cams, dev, aabb, trace_dir)
    render_cpu_check(SEMANTIC, tree, params, cams, dev, aabb)
    del params
    torch.cuda.empty_cache()
    kernels["scatter_add_rows"] += scatter_step_phase(SEMANTIC, cfg, tree, dev)
    launches[f"train {SEMANTIC}"], in_step = train_phase(
        SEMANTIC, tree, dev, trace_dir, must_launch=scatter, every_step=scatter)
    scatter_in_step(SEMANTIC, kernels["scatter_add_rows"], in_step)
    train_cpu_check(SEMANTIC, tree, dev, SEMANTIC_CPU_SEEDS, witnesses=False)
    del tree
    torch.cuda.empty_cache()


def neus_method_phases(dev, cams, aabb, trace_dir, launches) -> None:
    """NeuS's phases, its SDF field seeded with the geometric init: one
    counted 960x540 frame at chunk 1024 (the SDF's normals under the
    render's no_grad) and a chunk of NEUS_CPU_RAYS checked on the CPU, the
    rendered normals beside rgb; train (1024-ray batches, the eikonal
    loss through a double backward); a CPU check of one step of
    NEUS_CPU_RAYS with the witnesses, each leaf held with the card's
    sampler bins on both sides.  The path runs no hand-written kernel.
    Adds to ``launches``."""
    tree, params, _ = make_params(NEUS, dev)
    counted, steady, profile = NEUS_FRAMES
    launches[f"render {NEUS}"], _ = render_phase(
        NEUS, params, cams, dev, aabb, trace_dir, frames=counted,
        steady=steady, profile=profile)
    render_cpu_check(NEUS, tree, params, cams, dev, aabb, n=NEUS_CPU_RAYS)
    del params
    torch.cuda.empty_cache()
    launches[f"train {NEUS}"], _ = train_phase(NEUS, tree, dev, trace_dir,
                                               must_launch=())
    train_cpu_check(NEUS, tree, dev, NEUS_CPU_SEEDS, witnesses=True,
                    rays=NEUS_CPU_RAYS)
    del tree
    torch.cuda.empty_cache()


def proposal_updates(method, steps) -> int:
    """How many of the first ``steps`` steps update the proposals."""
    module, cfg, _camera_optimizer = method_parts(method)
    host = {"steps_since_update": 0}
    return sum(module.host_static_kwargs(cfg, step, host)["train_proposal_networks"]
               for step in range(steps))


def trainer_semantic_phase(dev, root, launches) -> None:
    """``Trainer.train`` of semantic-nerfw at registry width on a Sitcoms3D
    capture it writes (SITCOMS_FIXTURE: 20 cameras at 270x480, the layout
    of the real scenes' quarter-size images, with their "thing" labels),
    SEMANTIC_TRAINER_STEPS steps, an eval batch half way; then ``snt-eval``
    on the snapshot.  Fails unless the cache holds the labels, every train
    batch carries them (``semantics_loss`` finite and positive at every log
    step), scatter_add_rows launched 3 times per proposal-update step and
    once per other step, and psnr and ssim are finite."""
    from soccernerfs_tpu_torch.data.dataparsers.sitcoms3d import Sitcoms3DDataParserConfig
    from soccernerfs_tpu_torch.data.fixtures import make_sitcoms3d_fixture
    from soccernerfs_tpu_torch.engine.trainer import Trainer
    from soccernerfs_tpu_torch.scripts import eval as eval_script

    tag = f"trainer_semantic_nerfw {SEMANTIC}"
    t0 = time.perf_counter()
    data = make_sitcoms3d_fixture(root / "sitcoms3d", **SITCOMS_FIXTURE)
    fixture_s = time.perf_counter() - t0
    steps = SEMANTIC_TRAINER_STEPS
    cfg = trainer_config(SEMANTIC, Sitcoms3DDataParserConfig(data=data),
                         root / "out", "semantic", loop={
                             "max_num_iterations": steps, "steps_per_save": steps,
                             "steps_per_eval_batch": steps // 2,
                             "steps_per_eval_image": 0,
                             "steps_per_eval_all_images": 0, "vis": "none"})
    cfg.logging.steps_per_log = TRAINER_LOG_STEPS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = Trainer(cfg, device=dev).setup()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    sink = event_sink()
    if "semantics" not in trainer.datamanager.train_cache.cached_batch:
        raise AssertionError(f"{tag}: the cache holds no labels")
    side_s, save_s = [], []
    trainer.eval_iteration = timed(trainer.eval_iteration, side_s, sync=True)
    trainer.save_checkpoint = timed(trainer.save_checkpoint, save_s, sync=True)
    reset_launch_counts()
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches[f"trainer {SEMANTIC}"] = counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    check_finite_events(sink, tag)
    updates = proposal_updates(SEMANTIC, steps)
    if counts["scatter_add_rows"] != 3 * updates + (steps - updates):
        raise AssertionError(f"{tag}: scatter_add_rows launched "
                             f"{counts['scatter_add_rows']} times in {updates} "
                             f"update and {steps - updates} other steps")
    sem = {step: v for n, step, v in sink.scalars
           if n == "Train Loss Dict/semantics_loss"}
    log_steps = list(range(0, steps, TRAINER_LOG_STEPS))
    if sorted(sem) != log_steps or not all(np.isfinite(v) and v > 0
                                           for v in sem.values()):
        raise AssertionError(f"{tag}: semantics_loss at the log steps "
                             f"{log_steps}: {sem}")
    eval_sem = [v for n, _st, v in sink.scalars
                if n == "Eval Loss Dict/semantics_loss"]
    if len(eval_sem) != 1 or not np.isfinite(eval_sem[0]):
        raise AssertionError(f"{tag}: the eval batch's semantics_loss {eval_sem}")
    rays = trainer.datamanager.get_train_rays_per_batch()
    config = trainer.base_dir / "config.yml"
    del trainer
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    info = eval_script.main(["--load-config", str(config), "--output-path",
                             str(root / "semantic_eval.json")], device=dev)
    eval_s = time.perf_counter() - t0
    launches[f"cli eval {SEMANTIC}"] = launch_counts()
    results = info["results"]
    if not all(np.isfinite(results[k]) for k in ("psnr", "ssim")):
        raise AssertionError(f"{tag}: eval JSON {info}")
    log(json.dumps({
        "phase": "trainer_semantic_nerfw", "method": SEMANTIC, "card": card_line(),
        "fixture": {**SITCOMS_FIXTURE, "written_s": fixture_s},
        "steps": steps, "proposal_update_steps": updates, "setup_s": setup_s,
        "train_s": train_s,
        "loop_rays_per_s": rays * steps / (train_s - sum(side_s) - sum(save_s)),
        "trainstep_window_rays_per_s": WINDOW_RAYS_PER_S.get(SEMANTIC),
        "semantics_loss": sem, "eval_batch_semantics_loss": eval_sem[0],
        "save_ms": [1e3 * t for t in save_s], "peak_gib": peak,
        "eval": {k: results[k] for k in ("psnr", "ssim", "num_rays_per_sec",
                                         "fps")},
        "eval_s": eval_s,
        "eval_peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        "launches": {"trainer": counts,
                     "cli eval": launches[f"cli eval {SEMANTIC}"]}}))


def cli_neus_phase(dev, root, launches) -> None:
    """NeuS through the user entry points: ``snt-train neus ...
    nerfstudio-data`` at registry width on a nerfstudio ring it writes
    (NEUS_FIXTURE) for NEUS_CLI_STEPS steps; ``snt-eval`` over its eval
    split; a NEUS_RENDER_STEPS-frame ``snt-render`` spiral.  Fails unless the losses
    (the eikonal term among them) are finite at every log step, psnr and
    ssim are finite and every frame has its size."""
    from PIL import Image

    from soccernerfs_tpu_torch.data.fixtures import make_nerfstudio_fixture
    from soccernerfs_tpu_torch.engine.trainer import Trainer
    from soccernerfs_tpu_torch.scripts import eval as eval_script
    from soccernerfs_tpu_torch.scripts import render as render_script
    from soccernerfs_tpu_torch.scripts import train as train_script
    from soccernerfs_tpu_torch.utils import writer

    tag = f"cli_neus {NEUS}"
    t0 = time.perf_counter()
    data = make_nerfstudio_fixture(root / "nerfstudio_neus", **NEUS_FIXTURE)
    fixture_s = time.perf_counter() - t0
    argv = [NEUS, "--max-num-iterations", str(NEUS_CLI_STEPS), "--steps-per-save",
            str(NEUS_CLI_STEPS), "--vis", "none", "--output-dir",
            str(root / "cli_neus"), "nerfstudio-data", "--data", str(data)]
    log(f"{tag}: snt-train {' '.join(argv)}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sink = event_sink()
    setup_writers = writer.setup_writers

    def with_sink(*args, **kwargs):
        setup_writers(*args, **kwargs)
        writer._SINKS.append(sink)

    loop_s, save_s = [], []
    train, save = Trainer.train, Trainer.save_checkpoint
    Trainer.train = timed(train, loop_s, sync=True)
    Trainer.save_checkpoint = timed(save, save_s, sync=True)
    writer.setup_writers = with_sink
    try:
        trainer = train_script.main(argv, device=dev)
    finally:
        Trainer.train, Trainer.save_checkpoint = train, save
        writer.setup_writers = setup_writers
    check_finite_events(sink, tag)
    eikonal = {str(st): v for n, st, v in sink.scalars
               if n == "Train Loss Dict/eikonal_loss"}
    log_steps = range(0, NEUS_CLI_STEPS, trainer.config.logging.steps_per_log)
    if sorted(map(int, eikonal)) != list(log_steps):
        raise AssertionError(f"{tag}: eikonal_loss at {sorted(eikonal)}")
    rays = trainer.datamanager.get_train_rays_per_batch()
    config = trainer.base_dir / "config.yml"
    cams = trainer.eval_cameras
    peak = torch.cuda.max_memory_allocated() / 2**30
    del trainer
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    info = eval_script.main(["--load-config", str(config), "--output-path",
                             str(root / "cli_neus_eval.json")], device=dev)
    eval_s = time.perf_counter() - t0
    results = info["results"]
    if not all(np.isfinite(results[k]) for k in ("psnr", "ssim")):
        raise AssertionError(f"{tag}: eval JSON {info}")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    written = render_script.main(
        ["--load-config", str(config), "--traj", "spiral",
         "--interpolation-steps", str(NEUS_RENDER_STEPS), "--output-format",
         "images", "--output-path", str(root / "cli_neus_render" / "s.mp4")],
        device=dev)
    render_s = time.perf_counter() - t0
    pngs = sorted(written.glob("*.png"))
    sizes = {Image.open(f).size for f in pngs}
    if len(pngs) != NEUS_RENDER_STEPS or sizes != {(int(cams.width[0]),
                                                    int(cams.height[0]))}:
        raise AssertionError(f"{tag}: render: {len(pngs)} frames of {sizes}")
    log(json.dumps({
        "phase": "cli_neus", "method": NEUS, "card": card_line(),
        "fixture": {**NEUS_FIXTURE, "written_s": fixture_s},
        "train_argv": argv, "train_steps": NEUS_CLI_STEPS,
        "train_loop_rays_per_s": rays * NEUS_CLI_STEPS / (loop_s[0] - sum(save_s)),
        "train_loop_s": loop_s[0], "eikonal_loss": eikonal,
        "losses": {str(st): v for n, st, v in sink.scalars if n == "Train Loss"},
        "train_peak_gib": peak,
        "eval": {k: results[k] for k in ("psnr", "ssim", "num_rays_per_sec",
                                         "fps")},
        "eval_s": eval_s, "render_s": render_s, "render_frames": len(pngs)}))


def cli_export_phase(dev, root, launches) -> None:
    """The exporter's five subcommands (``scripts.exporter.main``, at
    EXPORT_ARGS: its defaults on the card) on ``cli_kplanes``' K-Planes
    snapshot: pointcloud, cameras, marching-cubes, tsdf and poisson, each
    timed, with the plane kernels it launched counted; then marching-cubes
    once more at the density's median on a 32^3 grid (the seeded
    snapshot's density stays below the default level 5, whose mesh is
    empty; at 128^3 the median's surface of this noisy field has ~12.7 M
    faces, which ``write_ply`` writes one Python call each, ~86 s).
    Fails unless each writes a non-empty PLY or JSON (a PLY's header, a
    JSON with both splits' cameras), the point cloud, the Poisson mesh and
    the median's mesh have vertices, the fused plane kernel launched in
    every subcommand but cameras, and no per-plane forward kernel in
    any."""
    from soccernerfs_tpu_torch.scripts import exporter
    from soccernerfs_tpu_torch.utils.eval_utils import eval_setup

    tag = f"cli_export {MODEL}"
    configs = sorted((root / "cli").glob("**/config.yml"))
    if len(configs) != 1:
        raise AssertionError(f"{tag}: cli_kplanes' snapshot: {configs}")
    out = root / "exports"
    _, trainer, _ = eval_setup(configs[0], "inference", device=dev)
    median = float(np.median(exporter.density_volume(trainer, 32, None)[0]))
    del trainer
    torch.cuda.empty_cache()
    runs = [(cmd, cmd, extra) for cmd, extra in EXPORT_ARGS.items()]
    runs.append(("marching-cubes at the median", "marching-cubes",
                 ["--resolution", "32", "--iso-level", repr(median)]))
    rows = {}
    for label, cmd, extra in runs:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        path = exporter.main([cmd, "--load-config", str(configs[0]),
                              "--output-dir", str(out / label.replace(" ", "_")),
                              *extra], device=dev)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches[f"cli export {label} {MODEL}"] = counts = launch_counts()
        raw = path.read_bytes()
        if path.suffix == ".json":
            cams = json.loads(raw)
            if not (cams.get("train") and cams.get("eval")):
                raise AssertionError(f"{tag}: {cmd} wrote {sorted(cams)}")
            sizes = {k: len(v) for k, v in cams.items()}
        else:
            head = raw.split(b"end_header\n")[0].decode().splitlines()
            sizes = {ln.split()[1]: int(ln.split()[2]) for ln in head
                     if ln.startswith("element")}
            if label != "marching-cubes" and not sizes.get("vertex"):
                raise AssertionError(f"{tag}: {label} wrote {sizes}")
        if cmd != "cameras" and counts["kplanes_fwd_fused"] <= 0:
            raise AssertionError(f"{tag}: {cmd} launched no fused plane kernel")
        if any(counts[k] for k in FORWARD):
            raise AssertionError(f"{tag}: {cmd} launched a per-plane forward "
                                 f"kernel: {counts}")
        rows[label] = {"s": seconds, "bytes": len(raw), "elements": sizes,
                       "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                       "args": extra, "launches": counts}
        log(f"{tag}: {label} {seconds:.3f} s, {path.name} {len(raw)} bytes "
            f"{sizes}, launches {counts}")
    log(json.dumps({"phase": "cli_export", "method": MODEL, "card": card_line(),
                    "density_median": median, "subcommands": rows}))


# the paper's resolution study through the ported sweep harness: its third
# parameter set (F = 24, scales 1..32: 2048^2 space planes), 32 steps on
# the Trainer phases' fixture, the render of a two-frame camera path, eval;
# then plot_kplane on the snapshot, compute_ist on the fixture and the
# snapshot's render against the CPU on SWEEP_CPU_RAYS rays
SWEEP = "kp_res_study"
SWEEP_RUN = 2
SWEEP_STEPS = 32
SWEEP_CPU_RAYS = 1024
SWEEP_OVERRIDES = {}              # dotted train flags over the run's params
# runs an entry point's command in its own process: chip_smoke's
# entry_point_report, its report as JSON to argv[1]
ENTRY_POINT_RUNNER = (
    "import json, sys\n"
    "sys.path.insert(0, sys.argv[1])\n"
    "import chip_smoke\n"
    "report = chip_smoke.entry_point_report(sys.argv[4], sys.argv[5:], sys.argv[3])\n"
    "open(sys.argv[2], 'w').write(json.dumps(report))\n")


def entry_point_report(module, args, device) -> dict:
    """Run entry point ``module``'s ``main(args, device=device)`` in this
    process, as ``python -m <module> <args>`` runs it on the card, with
    the launch counts at 0 before it; returns its report: wall seconds of
    main, of Trainer.train, Trainer.save_checkpoint and eval_setup within
    it (synchronised), the kernels' launches (the plane kernels' also by
    width), peak GiB, and what main returned (train: rays per batch and
    steps; eval: its results)."""
    import importlib

    from soccernerfs_tpu_torch.engine.trainer import Trainer
    from soccernerfs_tpu_torch.ops.kernels import plane_kernels as pk

    script = importlib.import_module(module)
    sync = torch.cuda.is_available()
    record = {"train": [], "save_checkpoint": [], "eval_setup": []}
    patched = [(Trainer, "train"), (Trainer, "save_checkpoint")]
    if hasattr(script, "eval_setup"):
        patched.append((script, "eval_setup"))
    saved = [(obj, name, getattr(obj, name)) for obj, name in patched]
    for obj, name, fn in saved:
        setattr(obj, name, timed(fn, record[name], sync=sync))
    reset_launch_counts()
    if sync:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        result = script.main(list(args), device=device)
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)
    if sync:
        torch.cuda.synchronize()
    report = {
        "module": module, "main_s": time.perf_counter() - t0,
        "seconds": {k: sum(v) for k, v in record.items()},
        "launches": launch_counts(),
        "by_width": {k.__name__: {str(f): c for f, c in k.launches_by_width.items()}
                     for k in pk.KERNELS},
        "peak_gib": (torch.cuda.max_memory_allocated() / 2**30 if sync else 0.0),
    }
    if isinstance(result, dict):
        report["results"] = result.get("results")
    elif hasattr(result, "datamanager"):
        report["rays_per_batch"] = result.datamanager.get_train_rays_per_batch()
        report["steps"] = result.config.max_num_iterations
    return report


def run_entry_point(cmd, dev) -> dict:
    """An Experiment's command, ``python -m <module> <args>``, run in its
    own process as ENTRY_POINT_RUNNER runs it (its report through a file
    beside the run; the process's output logged on failure)."""
    with tempfile.NamedTemporaryFile(suffix=".json", delete=False) as f:
        report = Path(f.name)
    full = [cmd[0], "-c", ENTRY_POINT_RUNNER, str(HERE), str(report), str(dev),
            cmd[2], *cmd[3:]]
    t0 = time.perf_counter()
    proc = subprocess.run(full, cwd=HERE, capture_output=True, text=True)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        log(proc.stdout[-4000:], proc.stderr[-4000:])
        raise AssertionError(f"{' '.join(cmd[2:4])} exited {proc.returncode}")
    out = json.loads(report.read_text())
    report.unlink()
    return {**out, "process_s": wall}


def sweep_camera_path(data, path) -> None:
    """A two-frame camera_path.json: the fixture's eval camera (Camera_20)
    at its first two time steps, in the parser's scene frame."""
    from soccernerfs_tpu_torch.data.dataparsers import DATAPARSERS

    cams = DATAPARSERS["broadcaststyle-data"](data=data, fps_downsample=1.0) \
        .setup().get_dataparser_outputs("test").cameras
    frames = []
    for i in range(2):
        c2w = np.eye(4)
        c2w[:3] = cams.camera_to_worlds[i].cpu().numpy()
        h, fy = int(cams.height[i]), float(cams.fy[i])
        frames.append({"camera_to_world": c2w.flatten().tolist(),
                       "fov": float(np.degrees(2 * np.arctan(h / 2 / fy))),
                       "aspect": float(cams.width[i]) / h,
                       "render_time": float(cams.times[i])})
    path.write_text(json.dumps({"render_height": int(cams.height[0]),
                                "render_width": int(cams.width[0]),
                                "camera_path": frames, "seconds": 2.0,
                                "fps": 1}))


def sweep_phase(dev, root, launches) -> None:
    """The paper's resolution study on the port: ``sweeps.experiment``
    (the ported Experiment) runs kp_res_study's run SWEEP_RUN (k-planes,
    F = 24, scales 1..32 over 64^3 x 100: 2048^2 space planes) on the
    Trainer phases' broadcaststyle fixture (the dataparser swapped in for
    the driver's stadium scene), SWEEP_STEPS steps with trainer_kplanes'
    data overrides, then snt-render of a two-frame camera path and
    snt-eval (DynMetric's boxes from a sidecar), each command in its own
    process (run_entry_point); then scripts.plot_kplane on the snapshot,
    scripts.compute_ist on the fixture, and the snapshot's render on
    SWEEP_CPU_RAYS rays of eval camera 0 against the CPU.  Fails unless
    every command succeeded, the train command launched the train path's
    plane kernels at F = 24 (bilerp_fwd_packed, bilerp_bwd_unpacked) and
    render and eval the fused one at F = 24 and no per-plane forward
    kernel, the eval's metrics are finite, the frames, plane PNGs and the
    IST cache exist, and the CPU check holds (2e-3)."""
    from soccernerfs_tpu_torch.experiments import snt_experiment, sweeps
    from soccernerfs_tpu_torch.scripts import compute_ist, plot_kplane
    from soccernerfs_tpu_torch.utils import eval_utils

    tag = f"sweep_kp_res {SWEEP}"
    data = root / "broadcaststyle"
    cam_path = root / "sweep_camera_path.json"
    sweep_camera_path(data, cam_path)
    boxes = root / "sweep_boxes.json"
    boxes.write_text(json.dumps(ball_boxes(data)))
    train_args = ["--max-num-iterations", str(SWEEP_STEPS), "--steps-per-save",
                  str(SWEEP_STEPS), "--vis", "none"]
    for key, value in TRAINER_DATA.items():
        train_args += [f"--pipeline.datamanager.{key.replace('_', '-')}", str(value)]
    for key, value in SWEEP_OVERRIDES.items():
        train_args += [f"--{key}", *str(value).split()]
    snt_experiment.OUTPUT_ROOT = root / "sweeps"
    exp = sweeps.experiment(SWEEP, runs=[SWEEP_RUN], cam_path=str(cam_path),
                            extra_args={"train": train_args,
                                        "render": ["--output-format", "images"]})
    exp.dataset = f"broadcaststyle-data --fps-downsample 1 --data {data}"
    reports = {}

    def sh(cmd):
        log(f"{tag}: {' '.join(cmd[2:])}")
        kind = cmd[2].rsplit(".", 1)[1]
        reports[kind] = run_entry_point(cmd, dev)
        launches[f"sweep {kind} {SWEEP}"] = reports[kind]["launches"]

    exp._sh = sh
    release_memory()
    saved_env = os.environ.get("SNT_DYNMETRIC_BOXES")
    os.environ["SNT_DYNMETRIC_BOXES"] = str(boxes)
    try:
        exp.run(do_eval=True, do_render=True)
    finally:
        if saved_env is None:
            del os.environ["SNT_DYNMETRIC_BOXES"]
        else:
            os.environ["SNT_DYNMETRIC_BOXES"] = saved_env
    if sorted(reports) != ["eval", "render", "train"]:
        raise AssertionError(f"{tag}: ran {sorted(reports)}")
    feat = exp.params[0]["pipeline.model.feature-dim"]
    need = {"train": ("bilerp_fwd_packed", "bilerp_bwd_unpacked"),
            "render": ("kplanes_fwd_fused",), "eval": ("kplanes_fwd_fused",)}
    for kind, names in need.items():
        by_width = reports[kind]["by_width"]
        missing = [n for n in names if by_width[n].get(feat, 0) <= 0]
        if missing:
            raise AssertionError(f"{tag}: {kind} launched no {missing} at F = "
                                 f"{feat}: {by_width}")
        if kind != "train" and any(reports[kind]["launches"][n] for n in FORWARD):
            raise AssertionError(f"{tag}: {kind} launched a per-plane forward "
                                 f"kernel: {reports[kind]['launches']}")
    train, render, evaluate = reports["train"], reports["render"], reports["eval"]
    results = evaluate["results"]
    if not all(np.isfinite(results[k]) for k in ("psnr", "ssim", "dpsnr", "dssim")):
        raise AssertionError(f"{tag}: eval results {results}")
    config = exp.get_config_path()
    frames = sorted(Path(str(exp.get_render_path(0))).parent.rglob("*.png"))
    if len(frames) != 2:
        raise AssertionError(f"{tag}: rendered frames {frames}")
    loop_s = train["seconds"]["train"] - train["seconds"]["save_checkpoint"]
    frame_s = (render["main_s"] - render["seconds"]["eval_setup"]) / 2

    # the tools on the snapshot and the fixture, in process; the CPU check
    # below takes plot_kplane's snapshot
    release_memory()
    setup, snapshot = eval_utils.eval_setup, []

    def kept_setup(*args, **kwargs):
        snapshot.append(setup(*args, **kwargs))
        return snapshot[-1]

    t0 = time.perf_counter()
    eval_utils.eval_setup = kept_setup
    try:
        planes_dir = plot_kplane.main(["--load-config", str(config), "--out",
                                       str(root / "sweep_planes"), "--device",
                                       str(dev)])
    finally:
        eval_utils.eval_setup = setup
    plot_s = time.perf_counter() - t0
    pngs = sorted(p.name for p in planes_dir.glob("*.png"))
    if len(pngs) != 36 and not SWEEP_OVERRIDES:
        raise AssertionError(f"{tag}: plot_kplane wrote {pngs}")
    t0 = time.perf_counter()
    weights = compute_ist.main(["--data", str(data), "--dataparser",
                                "broadcaststyle-data", "--device", str(dev)])
    torch.cuda.synchronize()
    ist_s = time.perf_counter() - t0
    caches = sorted(data.glob("images/*/ist-weights-1_0-train-*.npy"))
    if len(caches) != 1 or not np.isfinite(weights.astype(np.float32)).all():
        raise AssertionError(f"{tag}: compute_ist wrote {caches}")

    # the snapshot's render, card against CPU
    (_, trainer, step), = snapshot
    model, cfg = trainer.model, trainer.model_cfg
    staged = model.prepare_render_params(cfg, trainer.state.params)
    render_cpu_check(SWEEP, tree_to(trainer.state.params, "cpu"), staged,
                     trainer.eval_cameras, dev, trainer.aabb, n=SWEEP_CPU_RAYS,
                     parts=(model, cfg))
    grids = trainer.state.params["fields"]["grids"]
    n_params = sum(g.numel() for scale in grids for g in scale)
    del trainer, staged
    release_memory()
    log(json.dumps({
        "phase": "sweep_kp_res", "driver": SWEEP, "run": SWEEP_RUN,
        "params": exp.params[0], "checkpoint_step": step,
        "field_plane_params": n_params,
        "field_plane_shapes": [list(g.shape) for g in grids[-1]],
        "train": {"loop_rays_per_s": train["rays_per_batch"] * train["steps"] / loop_s,
                  "loop_s": loop_s, "save_s": train["seconds"]["save_checkpoint"],
                  "process_s": train["process_s"], "peak_gib": train["peak_gib"],
                  "launches_by_width": train["by_width"]},
        "render": {"s_per_frame": frame_s, "process_s": render["process_s"],
                   "eval_setup_s": render["seconds"]["eval_setup"],
                   "peak_gib": render["peak_gib"],
                   "launches_by_width": render["by_width"]},
        "eval": {"rays_per_s": results["num_rays_per_sec"], "fps": results["fps"],
                 "psnr": results["psnr"], "ssim": results["ssim"],
                 "process_s": evaluate["process_s"], "peak_gib": evaluate["peak_gib"],
                 "launches_by_width": evaluate["by_width"]},
        "plot_kplane_s": plot_s, "plane_pngs": len(pngs),
        "compute_ist_s": ist_s, "ist_cache": caches[0].name}))


def release_memory() -> None:
    """Free what earlier runs left (a trainer in a reference cycle lives
    until a collection) and restart the peak, so that a run's peak memory
    is its own."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def watch_groups(trainer) -> dict:
    """The first leaf of every param group, copied."""
    from soccernerfs_tpu_torch.utils.tree import tree_leaves

    return {name: tree_leaves(group)[0].detach().clone()
            for name, group in trainer.state.params.items()}


def stuck_groups(trainer, watch) -> list:
    """The param groups whose first leaf did not move since ``watch``."""
    from soccernerfs_tpu_torch.utils.tree import tree_leaves

    return [name for name, before in watch.items()
            if torch.equal(before, tree_leaves(trainer.state.params[name])[0])]


def cli_process_data_phase(dev, root, launches) -> None:
    """A user's own capture through the entry points: a COLMAP binary model
    (CAPTURE_FIXTURE: 20 OPENCV cameras with small distortions on a ring
    around the ball scene, their renders named as in images.bin) turned
    into transforms.json by ``snt-process-data colmap-to-json``; the
    nerfstudio parser's train cameras must be the ring's camera-to-worlds
    after its orientation and scale (POSE_TOL) with each frame's k1, k2,
    p1, p2; ``snt-train nerfacto`` (SO3xR3 on, as registered) on it,
    CAPTURE_STEPS steps with an eval image at CAPTURE_EVAL_IMAGE;
    ``snt-eval`` on the snapshot; ``images --skip-colmap --camera-type
    equirectangular`` on a seeded PANORAMA.  Fails unless the losses, the
    eval image's PSNR and eval's metrics are finite, every param group
    moved, the scatter's range check passes, scatter_add_rows launched in
    training and the panorama gave 8 crops of the size
    ``compute_resolution_from_equirect`` picks."""
    from PIL import Image

    from soccernerfs_tpu_torch.data.dataparsers import DATAPARSERS
    from soccernerfs_tpu_torch.data.fixtures import (
        make_colmap_fixture,
        make_equirect_panorama,
        ring_poses,
    )
    from soccernerfs_tpu_torch.engine.trainer import Trainer
    from soccernerfs_tpu_torch.ops.kernels import scatter_kernels as sk
    from soccernerfs_tpu_torch.scripts import eval as eval_script
    from soccernerfs_tpu_torch.scripts import process_data, sfm_tools
    from soccernerfs_tpu_torch.scripts import train as train_script
    from soccernerfs_tpu_torch.utils import writer

    tag = f"cli_process_data {NERFACTO}"
    t0 = time.perf_counter()
    data = make_colmap_fixture(root / "capture", camera_models=("OPENCV",),
                               binary=True, seed=SEED, **CAPTURE_FIXTURE)
    fixture_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    process_data.main(["colmap-to-json", "--sparse", str(data / "sparse" / "0"),
                       "--output-dir", str(data)])
    colmap_s = time.perf_counter() - t0

    # the poses and distortions the nerfstudio parser reads back
    outputs = DATAPARSERS["nerfstudio-data"](data=data).setup(
    ).get_dataparser_outputs("train")
    n = CAPTURE_FIXTURE["num_frames"]
    frames = json.loads((data / "transforms.json").read_text())["frames"]
    train_idx = np.linspace(0, n - 1, len(outputs.image_filenames), dtype=int)
    transform = np.concatenate([np.asarray(outputs.dataparser_transform,
                                           np.float64), [[0, 0, 0, 1]]])
    want = transform @ ring_poses(n, SEED)[train_idx]
    want[:, :3, 3] *= outputs.dataparser_scale
    pose_err = float(np.abs(outputs.cameras.camera_to_worlds.numpy()
                            - want[:, :3]).max())
    dist = outputs.cameras.distortion_params.numpy()
    want_dist = np.array([[frames[i].get(k, 0.0) for k in ("k1", "k2", "k3",
                                                           "k4", "p1", "p2")]
                          for i in train_idx], np.float32)
    if (pose_err > POSE_TOL or not np.array_equal(dist, want_dist)
            or not np.abs(dist[:, [0, 1, 4, 5]]).min() > 0):
        raise AssertionError(f"{tag}: parsed poses off by {pose_err:.3e}, "
                             f"distortion {dist[:2]} against {want_dist[:2]}")

    argv = [NERFACTO, "--max-num-iterations", str(CAPTURE_STEPS),
            "--steps-per-save", str(CAPTURE_STEPS), "--steps-per-eval-image",
            str(CAPTURE_EVAL_IMAGE), "--vis", "none", "--output-dir",
            str(root / "cli_capture"), "nerfstudio-data", "--data", str(data)]
    log(f"{tag}: snt-train {' '.join(argv)}")
    release_memory()
    sink = event_sink()
    setup_writers = writer.setup_writers

    def with_sink(*args, **kwargs):
        setup_writers(*args, **kwargs)
        writer._SINKS.append(sink)

    loop_s, side_s, save_s, watch = [], [], [], {}
    train, save, eval_image = (Trainer.train, Trainer.save_checkpoint,
                               Trainer.eval_image)

    def watched_train(self):
        watch.update(watch_groups(self))
        return train(self)

    Trainer.train = timed(watched_train, loop_s, sync=True)
    Trainer.save_checkpoint = timed(save, save_s, sync=True)
    Trainer.eval_image = timed(eval_image, side_s, sync=True)
    writer.setup_writers = with_sink
    reset_launch_counts()
    try:
        trainer = train_script.main(argv, device=dev)
    finally:
        Trainer.train, Trainer.save_checkpoint = train, save
        Trainer.eval_image = eval_image
        writer.setup_writers = setup_writers
    launches[f"cli train {NERFACTO} capture"] = counts = launch_counts()
    sk.raise_if_out_of_range(dev)
    check_finite_events(sink, tag)
    stuck = stuck_groups(trainer, watch)
    image_psnr = [(st, v) for name, st, v in sink.scalars if name == "Test PSNR"]
    if (stuck or counts["scatter_add_rows"] <= 0 or len(image_psnr) != 1
            or not np.isfinite(image_psnr[0][1])):
        raise AssertionError(f"{tag}: stuck groups {stuck}, eval image "
                             f"{image_psnr}, launches {counts}")
    rays = trainer.datamanager.get_train_rays_per_batch()
    config = trainer.base_dir / "config.yml"
    peak = torch.cuda.max_memory_allocated() / 2**30
    groups = sorted(watch)
    del trainer
    release_memory()
    reset_launch_counts()
    t0 = time.perf_counter()
    info = eval_script.main(["--load-config", str(config), "--output-path",
                             str(root / "cli_capture_eval.json")], device=dev)
    eval_s = time.perf_counter() - t0
    launches[f"cli eval {NERFACTO} capture"] = launch_counts()
    results = info["results"]
    if not all(np.isfinite(results[k]) for k in ("psnr", "ssim",
                                                  "num_rays_per_sec")):
        raise AssertionError(f"{tag}: eval JSON {info}")

    # an equirectangular capture: perspective crops, no SfM
    raw = make_equirect_panorama(root / "panorama" / "pano.png", seed=SEED,
                                 **PANORAMA).parent
    size = sfm_tools.compute_resolution_from_equirect(raw, 8)
    t0 = time.perf_counter()
    process_data.main(["images", "--data", str(raw), "--output-dir",
                       str(root / "panorama_out"), "--skip-colmap",
                       "--camera-type", "equirectangular"])
    pano_s = time.perf_counter() - t0
    crops = sorted((root / "panorama_out" / "images").iterdir())
    sizes = {Image.open(p).size for p in crops}
    if len(crops) != 8 or sizes != {size}:
        raise AssertionError(f"{tag}: panorama gave {len(crops)} crops of "
                             f"{sizes}, want 8 of {size}")
    log(json.dumps({
        "phase": "cli_process_data", "method": NERFACTO, "card": card_line(),
        "fixture": {**CAPTURE_FIXTURE, "camera_model": "OPENCV",
                    "written_s": fixture_s},
        "colmap_to_json_s": colmap_s, "pose_max_abs_err": pose_err,
        "distortion_max": float(np.abs(dist).max()),
        "train_argv": argv, "train_steps": CAPTURE_STEPS,
        "train_loop_s": loop_s[0],
        "loop_rays_per_s": rays * CAPTURE_STEPS
        / (loop_s[0] - sum(save_s) - sum(side_s)),
        "losses": {str(st): v for n, st, v in sink.scalars if n == "Train Loss"},
        "eval_image_psnr": image_psnr[0][1], "param_groups": groups,
        "train_peak_gib": peak,
        "eval": {k: results[k] for k in ("psnr", "ssim", "num_rays_per_sec",
                                         "fps")},
        "eval_s": eval_s,
        "eval_peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        "panorama": {**PANORAMA, "crops": len(crops), "crop_size": list(size),
                     "s": pano_s},
        "launches": {"cli train": counts,
                     "cli eval": launches[f"cli eval {NERFACTO} capture"]}}))


def trainer_parsers_phase(dev, root, launches) -> None:
    """Each of the remaining dataparsers that read local files, to the card
    through ``Trainer.train`` at registry width on a fixture it writes
    (PARSER_FIXTURE images, 8-12 train images), PARSER_STEPS steps:
    instant-ngp-data trains instant-ngp, dycheck-data k-planes (on its
    times), sdfstudio-data neus, and minimal-parser, phototourism-data,
    scannet-data and arkitscenes-data nerfacto.  Fails unless each run's
    losses (logged at step 0 and half way) are finite, the second
    positive, every param group moved and the scatter's range check
    passes.  Prints setup seconds, ms per step and rays/s."""
    from soccernerfs_tpu_torch.data import fixtures
    from soccernerfs_tpu_torch.data.dataparsers import DATAPARSERS
    from soccernerfs_tpu_torch.engine.trainer import Trainer
    from soccernerfs_tpu_torch.ops.kernels import scatter_kernels as sk

    runs = (("instant-ngp-data", NGP, fixtures.make_instant_ngp_fixture,
             {"num_frames": 10}),
            ("dycheck-data", MODEL, fixtures.make_dycheck_fixture,
             {"num_frames": 10}),
            ("sdfstudio-data", NEUS, fixtures.make_sdfstudio_fixture,
             {"num_frames": 10}),
            ("minimal-parser", NERFACTO, fixtures.make_minimal_fixture,
             {"num_frames": 12}),
            ("phototourism-data", NERFACTO, fixtures.make_phototourism_fixture,
             {"num_images": 12}),
            ("scannet-data", NERFACTO, fixtures.make_scannet_fixture,
             {"num_frames": 10}),
            ("arkitscenes-data", NERFACTO, fixtures.make_arkitscenes_fixture,
             {"num_frames": 10}))
    rows = {}
    for name, method, write, sizes in runs:
        tag = f"trainer_parsers {name} {method}"
        t0 = time.perf_counter()
        data = write(root / "parsers" / name, seed=SEED, **sizes,
                     **PARSER_FIXTURE)
        fixture_s = time.perf_counter() - t0
        cfg = trainer_config(method, DATAPARSERS[name](data=data),
                             root / "out", f"parsers_{name}", loop={
                                 "max_num_iterations": PARSER_STEPS,
                                 "steps_per_save": PARSER_STEPS,
                                 "steps_per_eval_batch": 0,
                                 "steps_per_eval_image": 0,
                                 "steps_per_eval_all_images": 0,
                                 "vis": "none"})
        cfg.logging.steps_per_log = PARSER_STEPS // 2
        release_memory()
        t0 = time.perf_counter()
        trainer = Trainer(cfg, device=dev).setup()
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        sink = event_sink()
        save_s = []
        trainer.save_checkpoint = timed(trainer.save_checkpoint, save_s,
                                        sync=True)
        watch = watch_groups(trainer)
        reset_launch_counts()
        t0 = time.perf_counter()
        trainer.train()
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        launches[f"trainer {method} {name}"] = counts = launch_counts()
        sk.raise_if_out_of_range(dev)
        check_finite_events(sink, tag)
        stuck = stuck_groups(trainer, watch)
        # instant-ngp's first step sees an empty occupancy grid: no ray
        # is alive and its masked loss is 0; its grid fills after it
        losses = [v for n, _st, v in sink.scalars if n == "Train Loss"]
        if stuck or len(losses) != 2 or not losses[-1] > 0:
            raise AssertionError(f"{tag}: stuck param groups {stuck}, "
                                 f"losses {losses}")
        rays = trainer.datamanager.get_train_rays_per_batch()
        loop_s = train_s - sum(save_s)
        rows[name] = {
            "method": method, "fixture": {**sizes, **PARSER_FIXTURE,
                                          "written_s": fixture_s},
            "train_images": len(trainer.datamanager.train_dataset),
            "times": trainer.train_cameras.times is not None,
            "setup_s": setup_s, "ms_per_step": 1e3 * loop_s / PARSER_STEPS,
            "rays_per_s": rays * PARSER_STEPS / loop_s, "losses": losses,
            "param_groups": sorted(watch),
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "launches": counts}
        log(f"{tag}: setup {setup_s:.3f} s, {rows[name]['ms_per_step']:.2f} ms "
            f"per step, {rows[name]['rays_per_s']:.0f} rays/s, "
            f"{rows[name]['train_images']} train images, launches {counts}")
        del trainer
    release_memory()
    log(json.dumps({"phase": "trainer_parsers", "card": card_line(),
                    "steps": PARSER_STEPS, "parsers": rows}))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--trace", default=None,
                        help="directory for chrome traces of one frame and "
                             "of one update and one non-update train step "
                             "per method")
    args = parser.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    import soccernerfs_tpu_torch

    if Path(soccernerfs_tpu_torch.__file__).resolve().parents[1] != HERE:
        print("chip_smoke: soccernerfs_tpu_torch is not beside this script",
              file=sys.stderr)
        return 1
    from soccernerfs_tpu_torch.ops.kernels import build
    from soccernerfs_tpu_torch.ops.kernels import plane_kernels as pk
    from soccernerfs_tpu_torch.ops.kernels import scatter_kernels as sk

    dev = torch.device(DEVICE)
    card = card_line()
    log("card:", card)
    log("torch", torch.__version__, "cuda", torch.version.cuda,
        "python", sys.version.split()[0])

    t0 = time.perf_counter()
    libs = build.build_all([*pk.LIBRARIES, *sk.LIBRARIES])
    log(f"build: {time.perf_counter() - t0:.3f} s, {[lib.name for lib in libs]}")
    for lib in libs:
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log("ptxas:", line.strip())

    aabb = torch.tensor(AABB, device=dev)
    cams = make_cameras(dev)
    kernels, launches = {}, {}

    # ---- K-Planes: plane kernels, render, train
    _module, cfg, _camera_optimizer = method_parts(MODEL)
    tree, params, staged = make_params(MODEL, dev, time_noise=0.05)
    kernels.update(kernel_phase(cfg, staged, dev))
    kernels.update(fused_kernel_phase(cfg, staged, cams, dev, aabb))
    kernels.update(bwd_kernel_phase(cfg, params, tree, dev))
    # the other feature widths, off the main path's shapes
    t0 = time.perf_counter()
    for name, rows in width_kernel_phase(cfg, dev).items():
        kernels[name] += rows
    log(f"width_kernel_phase: {time.perf_counter() - t0:.3f} s")
    # the render path: the fused kernel, and no per-plane forward kernel
    launches[f"render {MODEL}"], in_frame = render_phase(
        MODEL, staged, cams, dev, aabb, args.trace,
        must_launch=[pk.kplanes_fwd_fused.__name__], must_not_launch=FORWARD)
    n_chunks = -(-H * W // cfg.eval_num_rays_per_chunk)
    for name, bound in frame_plane_bound_ms(cfg, staged, n_chunks).items():
        log(f"in-frame {name}: {in_frame[name]:.3f} ms device, bound "
            f"{bound:.3f} ms (bytes, whole tables per launch)"
            + (f", {bound / in_frame[name]:.4f} of bound" if in_frame[name] else ""))
    render_cpu_check(MODEL, tree, staged, cams, dev, aabb)
    del staged, params
    torch.cuda.empty_cache()
    fwd_bounds = fwd_step_bounds(tree, dev)
    launches[f"train {MODEL}"], in_step = train_phase(
        MODEL, tree, dev, args.trace,
        must_launch=[k.__name__ for k in pk.TRAIN_KERNELS])
    for update, (times, _counts) in in_step.items():
        log(f"in-step kernels, {MODEL} ({'update' if update else 'non-update'} "
            f"step): " + ", ".join(f"{k} {v:.3f} ms" for k, v in times.items()))
    # the forward kernels against the byte bound of the captured step's
    # launches: every step runs all of them
    for name, (step_launches, bound, whole) in fwd_bounds.items():
        for update, (times, counts) in in_step.items():
            if counts[name] != step_launches:
                raise AssertionError(f"{name}: {counts[name]} launches in the "
                                     f"profiled step, the captured step made "
                                     f"{step_launches}")
            log(f"in-step {name} ({'update' if update else 'non-update'} "
                f"step): {times[name]:.3f} ms device in {counts[name]} "
                f"launches, bound {bound:.3f} ms (bytes: the touched table "
                f"rows; {whole:.3f} ms with whole tables), "
                + (f"{bound / times[name]:.4f} of bound" if times[name]
                   else "not measured"))
    # the backward kernels against the byte bound of the captured step's
    # launches: an update step launches all of them, a non-update step
    # the unpacked ones only
    for name in ("bilerp_bwd_unpacked", "bilerp_bwd_packed"):
        ray = [r for r in kernels[name] if r["order"] == "ray"]
        step_launches, bound = len(ray), sum(r["bound_ms"] for r in ray)
        for update, (times, counts) in in_step.items():
            want = step_launches if update or name == "bilerp_bwd_unpacked" else 0
            if counts[name] != want:
                raise AssertionError(f"{name}: {counts[name]} launches in the "
                                     f"profiled step, the captured step made {want}")
            if want:
                log(f"in-step {name} ({'update' if update else 'non-update'} "
                    f"step): {times[name]:.3f} ms device in {counts[name]} "
                    f"launches, bound {bound:.3f} ms (bytes), "
                    + (f"{bound / times[name]:.4f} of bound" if times[name]
                       else "not measured"))
    # the caller's TF32 setting on: the step computes in full f32 all the
    # same, and leaves the setting as it found it
    saved_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        train_cpu_check(MODEL, tree, dev, TRAIN_CPU_SEEDS, witnesses=True)
        if torch.backends.cuda.matmul.allow_tf32 is not True:
            raise AssertionError("a K-Planes step left TF32 off")
        log(f"train cpu check {MODEL}: TF32 on before the steps; held, and "
            f"still on after them")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved_tf32
    del tree

    # ---- nerfacto: the scatter kernel, render, train (camera optimizer on)
    _module, ncfg, _camera_optimizer = method_parts(NERFACTO)
    # an appearance embedding per training camera: the ring's 20
    tree, params, _ = make_params(NERFACTO, dev, num_train_data=20)
    kernels.update(scatter_kernel_phase(ncfg, tree, dev))
    launches[f"render {NERFACTO}"], _ = render_phase(
        NERFACTO, params, cams, dev, aabb, args.trace)
    render_cpu_check(NERFACTO, tree, params, cams, dev, aabb)
    del params
    torch.cuda.empty_cache()
    scatter = [k.__name__ for k in sk.KERNELS]
    launches[f"train {NERFACTO}"], in_step = train_phase(
        NERFACTO, tree, dev, args.trace, must_launch=scatter, every_step=scatter)
    for update, (times, _counts) in in_step.items():
        log(f"in-step kernels, {NERFACTO} ({'update' if update else 'non-update'} "
            f"step): " + ", ".join(f"{k} {v:.3f} ms" for k, v in times.items()))
    scatter_in_step(NERFACTO, kernels["scatter_add_rows"], in_step)
    train_cpu_check(NERFACTO, tree, dev, NERFACTO_CPU_SEEDS, witnesses=False)
    del tree

    # ---- depth-nerfacto: nerfacto's render, and its step with the DS-NeRF
    # loss on batches with target depths (camera optimizer on); the
    # scatter's launches of one such step, captured, bound its in-step time
    _module, dcfg, _camera_optimizer = method_parts(DEPTH)
    tree, params, _ = make_params(DEPTH, dev, num_train_data=20)
    launches[f"render {DEPTH}"], _ = render_phase(DEPTH, params, cams, dev,
                                                  aabb, args.trace)
    del params
    torch.cuda.empty_cache()
    kernels["scatter_add_rows"] += scatter_step_phase(DEPTH, dcfg, tree, dev)
    launches[f"train {DEPTH}"], in_step = train_phase(
        DEPTH, tree, dev, args.trace, must_launch=scatter, every_step=scatter)
    # 3 launches per update step, 1 per other step
    scatter_in_step(DEPTH, kernels["scatter_add_rows"], in_step)
    train_cpu_check(DEPTH, tree, dev, DEPTH_CPU_SEEDS, witnesses=True)
    del tree

    # ---- semantic-nerfw: nerfacto with the semantic head
    t0 = time.perf_counter()
    semantic_method_phases(dev, cams, aabb, args.trace, kernels, launches)
    log(f"semantic_method_phases {SEMANTIC}: {time.perf_counter() - t0:.3f} s")

    # ---- nerfplayer-nerfacto (temporal hash grids) and nerfplayer (the
    # decomposition field), camera optimizer off as registered; the
    # scatter's width-1 launches
    for method in (NERFPLAYER, NP):
        proposal_method_phases(method, dev, cams, aabb, args.trace, kernels,
                               launches)

    # ---- the occupancy-grid methods
    for method in (INGP, NPNGP, NPNGPC):
        occupancy_method_phases(method, dev, cams, aabb, args.trace, kernels,
                                launches)

    # ---- the classic methods: TensoRF, vanilla NeRF, mip-NeRF
    for method in (TENSORF, VNERF, MIPNERF):
        t0 = time.perf_counter()
        classic_method_phases(method, dev, cams, aabb, args.trace, launches)
        log(f"classic_method_phases {method}: {time.perf_counter() - t0:.3f} s")

    # ---- NeuS: the SDF field, its sampler and the eikonal double backward
    t0 = time.perf_counter()
    neus_method_phases(dev, cams, aabb, args.trace, launches)
    log(f"neus_method_phases {NEUS}: {time.perf_counter() - t0:.3f} s")

    # ---- the Trainer phases: the data path, checkpoints, the gate
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trainer_") as root:
        for phase in (trainer_kplanes_phase, trainer_kplanes_depth_phase,
                      trainer_ingp_phase, convergence_phase,
                      trainer_tensorf_phase, trainer_kplanes_hypernerf_phase,
                      cli_phase, cli_depth_phase, cli_ingp_phase,
                      cli_dnerf_phase, trainer_semantic_phase, cli_neus_phase,
                      cli_export_phase, cli_process_data_phase,
                      trainer_parsers_phase, sweep_phase):
            t0 = time.perf_counter()
            phase(dev, Path(root), launches)
            log(f"{phase.__name__}: {time.perf_counter() - t0:.3f} s")

    pallas = "soccernerfs_tpu/ops/pallas/plane_kernels.py"
    replaces = {
        "bilerp_fwd_unpacked": (f"{pallas}:591", "plane_kernels.cu"),
        "bilerp_fwd_packed": (f"{pallas}:1062", "plane_kernels.cu"),
        "bilerp_bwd_unpacked": (f"{pallas}:1418", "plane_bwd_kernels.cu"),
        "bilerp_bwd_packed": (f"{pallas}:1156", "plane_bwd_kernels.cu"),
        "scatter_add_rows": (f"{pallas}:1342", "scatter_kernels.cu"),
        # the render path's launches of both forward kernels, fused
        "kplanes_fwd_fused": (f"{pallas}:591,1062", "plane_kernels.cu"),
    }
    log("main-path launches:", json.dumps(launches))
    summary = []
    for name in (k.__name__ for k in all_kernels()):
        # the kernel phases' own cases at the main paths' widths, as
        # earlier runs summed them; the backward kernels' captured
        # train-step launches and the other widths' cases have lines of
        # their own; the fused kernel's cases are a frame's own launches
        rows = [r for r in kernels[name] if r.get("order") != "width"]
        rows = [r for r in rows
                if r.get("order", "random") == "random"] or rows
        t_bytes = sum(r["bytes"] for r in rows) / H100_BYTES_PER_S * 1e3
        t_ops = sum(r["flops"] for r in rows) / H100_F32_FLOPS * 1e3
        count = sum(path[name] for path in launches.values())
        if count <= 0:
            raise AssertionError(f"{name} was launched on no main path")
        summary.append({
            "name": name, "route": "cuda",
            "source": f"soccernerfs_tpu_torch/csrc/{replaces[name][1]}",
            "replaces": replaces[name][0],
            # every main path: each was driven with the counts at 0 just
            # before it and read just after
            "launches": count,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": sum(r["ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": sum(r["library_ms"] for r in rows),
        })
    log(json.dumps({"kernels": summary}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
