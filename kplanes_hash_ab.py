#!/usr/bin/env python3
"""Check that checkouts of this repository compute the registered K-Planes
alike, in turns on one CUDA card (run them as P C C P).

Each argument is the root of a checkout (``.`` for this one); each turn
runs in a fresh process from that checkout, with its own
``soccernerfs_tpu_torch`` and ``chip_smoke.py``, and prints one JSON line:
the sha256 of camera 0's 960x540 frame outputs and of one train forward's
loss terms (an update step and another, the same batch and draws: the
forwards use no atomics, so equal code gives equal bits), the plane
kernels' launches in each of those steps, the sha256 of the values one
``TrainStep.train_iteration`` returns, the window rays/s of chip_smoke's
K-Planes train phase, and whether a process group exists after it.  Then a last JSON line with every turn.

Usage (from the repository root; needs CUDA):
    python3 kplanes_hash_ab.py PARENT_TREE . . PARENT_TREE
"""
import json
import subprocess
import sys
from pathlib import Path

TURN = r"""
import hashlib, json, sys
import torch
sys.path.insert(0, ".")
import chip_smoke as cs
from soccernerfs_tpu_torch.configs.method_configs import train_num_rays_per_batch
from soccernerfs_tpu_torch.engine.render import render_camera
dev = torch.device("cuda")
aabb = torch.tensor(cs.AABB, device=dev)
cams = cs.make_cameras(dev)
_m, cfg, _c = cs.method_parts(cs.MODEL)
tree, params, staged = cs.make_params(cs.MODEL, dev, time_noise=0.05)
out = {}
fr = render_camera(cfg, staged, cams, 0, device=dev, aabb=aabb, model="kplanes")
out["frame"] = hashlib.sha256(b"".join(fr[k].cpu().numpy().tobytes() for k in sorted(fr))).hexdigest()[:16]
del params, staged, fr
torch.cuda.empty_cache()
trainer, state = cs.make_trainer(cs.MODEL, tree, dev)
counts = {}
for flag in (True, False):
    cs.reset_launch_counts()
    loss, ld, met, grads = trainer.loss_and_grads(
        state, cs.make_batch(0, train_num_rays_per_batch[cs.MODEL], dev),
        train_proposal_networks=flag,
        generator=torch.Generator(device=dev).manual_seed(cs.SEED))
    counts["update" if flag else "other"] = cs.launch_counts()
    out[f"loss terms {'update' if flag else 'other'}"] = hashlib.sha256(
        b"".join(v.cpu().numpy().tobytes() for k, v in sorted(ld.items()))).hexdigest()[:16]
    del grads
out["launches"] = counts
# one whole step through train_iteration (the forward's values it returns)
m = trainer.train_iteration(
    state, cs.make_batch(0, train_num_rays_per_batch[cs.MODEL], dev),
    torch.Generator(device=dev).manual_seed(cs.SEED))
out["train_iteration values"] = hashlib.sha256(
    b"".join(v.cpu().numpy().tobytes() for k, v in sorted(m.items()))).hexdigest()[:16]
del trainer, state
torch.cuda.empty_cache()
cs.train_phase(cs.MODEL, tree, dev, None, must_launch=["bilerp_fwd_unpacked"])
out["window_rays_per_s"] = cs.WINDOW_RAYS_PER_S[cs.MODEL]
out["process_group"] = torch.distributed.is_initialized()
print("TURN " + json.dumps(out), flush=True)
"""

rows = []
for root in sys.argv[1:]:
    proc = subprocess.run([sys.executable, "-c", TURN], cwd=root,
                          capture_output=True, text=True)
    lines = proc.stdout.splitlines()
    for line in lines:
        if line.startswith("train k-planes: window") or line.startswith("TURN"):
            print(root, line[:600], flush=True)
    if proc.returncode:
        print(proc.stdout[-3000:], proc.stderr[-3000:])
        sys.exit(proc.returncode)
    rows.append({"root": root, **json.loads(lines[-1][5:])})
print(json.dumps(rows))
