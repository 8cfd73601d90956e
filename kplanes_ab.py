#!/usr/bin/env python3
"""Time K-Planes' render and train paths of checkouts of this repository
in turns, on one CUDA card, to compare two versions (run them as P C C P).

Each argument is the root of a checkout (``.`` for this one); each turn
runs in a fresh process from that checkout, with its own
``soccernerfs_tpu_torch`` and its own ``chip_smoke.py``, and drives:
  * chip_smoke's K-Planes render phase: the registry's k-planes at full
    width from numpy seed 0, two counted 960x540 frames, two timed ones
    (s/frame, test rays/s) and a profiled one (device time by kernel, busy
    share);
  * chip_smoke's K-Planes train phase: steps 0-11 and a 60-step window at
    step 10,000 (train rays/s, ms per update and other step);
  * chip_smoke's ``cli_kplanes`` phase on the ``trainer_kplanes`` fixture:
    snt-train (16 steps), snt-eval (eval rays/s), the viewer's /render
    (ms by size) and snt-render (s per frame by trajectory).
Each checkout's own script holds its own launch checks.  Prints every
turn's lines, then one JSON line per turn with its numbers, the card line
and a last JSON line with them all.

Usage (from any directory; needs CUDA):
    python3 kplanes_ab.py PARENT_TREE . . PARENT_TREE
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

TURN = r"""
import sys, tempfile
from pathlib import Path
import torch
sys.path.insert(0, ".")
import chip_smoke as cs
from soccernerfs_tpu_torch.data.fixtures import make_broadcaststyle_fixture

dev = torch.device("cuda")
aabb = torch.tensor(cs.AABB, device=dev)
cams = cs.make_cameras(dev)
tree, params, staged = cs.make_params(cs.MODEL, dev, time_noise=0.05)
del params
cs.render_phase(cs.MODEL, staged, cams, dev, aabb, None)
del staged
torch.cuda.empty_cache()
# the train path's four plane kernels, named alike in every checkout
cs.train_phase(cs.MODEL, tree, dev, None,
               must_launch=["bilerp_fwd_unpacked", "bilerp_fwd_packed",
                            "bilerp_bwd_unpacked", "bilerp_bwd_packed"])
torch.cuda.empty_cache()
with tempfile.TemporaryDirectory(prefix="kplanes_ab_") as root:
    root = Path(root)
    make_broadcaststyle_fixture(root / "broadcaststyle", with_depth=True,
                                **cs.TRAINER_FIXTURE)
    cs.cli_phase(dev, root, {})
"""


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def numbers(lines) -> dict:
    """The turn's end-to-end numbers from its lines."""
    row = {}
    for line in lines:
        if line.startswith("render k-planes: steady "):
            # "render k-planes: steady 0.8021 s/frame ([...]), 646310.9 test rays/s, ..."
            row["s_per_frame"] = float(line.split()[3])
            row["frame_s"] = json.loads(line.split("(", 1)[1].split(")")[0])
            row["test_rays_per_s"] = float(line.split("), ")[1].split()[0])
        elif line.startswith("profile render k-planes frame: wall"):
            row["profiled_frame"] = line.split(": ", 1)[1]
        elif line.startswith("train k-planes: window steps"):
            # "...: update steps 10 x 61.3 ms mean, ...; non-update steps
            # 50 x 58.4 ms mean, ...; 69538.1 train rays/s over the window; ..."
            parts = line.split("; ")
            row["update_step_ms"] = float(parts[0].split(" x ")[1].split()[0])
            row["other_step_ms"] = float(parts[1].split(" x ")[1].split()[0])
            row["train_rays_per_s"] = float(
                next(q for q in parts if "train rays/s over" in q).split()[0])
        elif line.startswith('{"phase": "cli_kplanes"'):
            cli = json.loads(line)
            row["cli_kplanes"] = {k: cli[k] for k in (
                "eval", "render_s_per_frame", "viewer_first_render_ms",
                "viewer_render_ms") if k in cli}
    return row


def main() -> int:
    trees = sys.argv[1:]
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("kplanes_ab: CUDA is not available", file=sys.stderr)
        return 1
    card = card_line()
    print("card:", card, flush=True)
    turns = []
    for i, tree in enumerate(trees):
        root = Path(tree).resolve()
        if not (root / "chip_smoke.py").is_file():
            print(f"kplanes_ab: {root} holds no chip_smoke.py", file=sys.stderr)
            return 1
        proc = subprocess.run([sys.executable, "-c", TURN], cwd=root,
                              capture_output=True, text=True)
        lines = proc.stdout.splitlines()
        for line in lines:
            print(f"[turn {i} {tree}] {line}", flush=True)
        if proc.returncode != 0:
            print(proc.stderr[-6000:], file=sys.stderr)
            print(f"kplanes_ab: turn {i} ({tree}) failed", file=sys.stderr)
            return 1
        row = {"turn": i, "tree": tree, **numbers(lines)}
        print(json.dumps(row), flush=True)
        turns.append(row)
    print(card)
    print(json.dumps({"card": card, "turns": turns}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
