"""Readings that set a cell's limits, on the chip at the cell's own size.

    python3 nerfbench/probe.py --workload <cell> --seeds 1,2,3 [--control 4,5,6] \
        [--faults 7,8,9] [--out <file.jsonl>]

For each of ``--seeds``, the numbers a sound run of the program compares
(the lower readings); for each of ``--control``, the same numbers of the
control, the reference in bf16 put in the program's place; for each of
``--faults``, those of the program with its timed path broken underneath
(harness/faults.py), each fault the cell can have.  One JSON object a
reading, on standard output and appended to ``--out``.  The benchmark's
runs do not run this; a train cell reads its first steps only, a render
cell renders the frames it compares and no window.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def seeds(text: str):
    return [int(s) for s in text.split(",") if s]


def train_readings(ctx, kind):
    from nerfbench.traffic import train_step as T

    step, state, pool, gen, table, record = T.setup(ctx)
    del step, state
    if kind == "control":
        return T.control(ctx, record, pool, table)
    return T.numbers(record, T.reference_readings(ctx, record, pool, table))


def render_readings(ctx, kind, traffic):
    """The numbers of ``check_frames`` images of the cell (no window): the
    program's (its fault, if any) or, for the control, the reference's
    in bf16 on the same sampled pixels."""
    import torch

    from nerfbench.harness import faults, port, scene
    from nerfbench.traffic import render_frames, view_loop

    dev = torch.device(ctx.device)
    cfg, cam = ctx.cfg, ctx.param("camera")
    mcfg = port.model_config(cfg)
    params = ctx.reference.make_params(cfg, ctx.seed, dev)
    render = faults.break_render(port.render, ctx.fault) if ctx.fault else port.render
    control = kind == "control"
    n = ctx.param("check_frames")
    if traffic == "render_frames":
        table = scene.render_table(dev, cam["height"], cam["width"], cam["focal"])
        cams = table.port_cameras(dev)
        ks = [(ctx.seed % scene.FRAMES + i) % scene.FRAMES for i in range(n)]
        frames = [(k, None if control else render(cfg, mcfg, params, cams, k, dev))
                  for k in ks]
        del params
        return render_frames.check(ctx, table, cam, frames, control)
    done = []
    for i in range(n):
        pose, t = scene.orbit_pose(ctx.seed % 360 + i)
        out = None if control else render(cfg, mcfg, params, port.camera(pose, t, cam, dev),
                                          0, dev, ctx.param("chunk"))
        done.append(((pose, t), out))
    del params
    return view_loop.check(ctx, done, control)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=seeds, default=[])
    parser.add_argument("--control", type=seeds, default=[])
    parser.add_argument("--faults", type=seeds, default=[])
    parser.add_argument("--out")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from nerfbench.harness import cell as C
    from nerfbench.harness import faults

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    from soccernerfs_tpu_torch.ops.kernels import build

    build.build_all(sorted(p.stem for p in build.CSRC.glob("*.cu")))
    dev = torch.device("cuda", 0)
    traffic = C.spec.workload(args.workload)["entry"]["traffic"]
    fault_names = faults.TRAIN if traffic == "train_step" else faults.RENDER
    plan = ([("program", s, None) for s in args.seeds]
            + [("control", s, None) for s in args.control]
            + [("fault", s, f) for s in args.faults for f in fault_names
               if f != "unchanged"])
    for kind, seed, fault in plan:
        t0 = time.perf_counter()
        ctx = C.context(args.workload, seed, dev)
        ctx.fault = fault
        if traffic == "train_step":
            nums = train_readings(ctx, kind)
        else:
            nums = render_readings(ctx, kind, traffic)
        rec = {"workload": args.workload, "kind": kind, "fault": fault, "seed": seed,
               "seconds": time.perf_counter() - t0, **nums}
        print(json.dumps(rec), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
