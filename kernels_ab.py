#!/usr/bin/env python3
"""Per-call times of the plane kernels of checkouts of this repository in
turns, on one CUDA card, to compare two versions (run them as P C C P).

Each argument is the root of a checkout (``.`` for this one); each turn
runs in a fresh process with that checkout's ``soccernerfs_tpu_torch``
(built there) and this checkout's ``chip_smoke.py`` as the harness, so
every turn measures the same cases the same way and only the kernels
differ.  On the registry's k-planes (weights from numpy seed 0) it runs
chip_smoke's plane kernel phases: the per-plane forward kernels on random
points at the render path's point counts and ``bilerp_fwd_unpacked`` at
the train path's (262,144 points) and on the 7 launches of one train step,
captured at the wrapper; the fused render kernel on a frame's captured
launches; the table backward kernels on random points and one train
step's launches; ``bilerp_bwd_coords`` on random points and on one SO3xR3
step's launches; every plane kernel at F = 16, 20, 24 and 48.  Each case
is held against its plain version as chip_smoke holds it.

It prints one JSON line per turn: the build's seconds; per kernel and
case order (random, train, ray: a step's launches, width: per F) the
cases' count, summed ms and byte bound, and the largest error against
the plain version; the sha256 of the forward kernels' outputs at F = 8
and 32 on seeded operands (equal hashes across checkouts: bit-equal
results).

Usage (from any directory; needs CUDA):
    python3 kernels_ab.py PARENT_TREE . . PARENT_TREE
"""
import json
import subprocess
import sys
from pathlib import Path

HARNESS = Path(__file__).resolve().parent / "chip_smoke.py"

TURN = r"""
import hashlib, importlib.util, json, sys, time
import torch
sys.path.insert(0, ".")
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
from soccernerfs_tpu_torch.ops.grid_sample import quad_pack
from soccernerfs_tpu_torch.ops.kernels import build, plane_kernels as pk, scatter_kernels as sk

t0 = time.perf_counter()
build.build_all([*pk.LIBRARIES, *sk.LIBRARIES])
out = {"build_s": time.perf_counter() - t0}
dev = torch.device("cuda")
aabb = torch.tensor(cs.AABB, device=dev)
cams = cs.make_cameras(dev)
_module, cfg, _camera_optimizer = cs.method_parts(cs.MODEL)
tree, params, staged = cs.make_params(cs.MODEL, dev, time_noise=0.05)
rows = {}
rows.update(cs.kernel_phase(cfg, staged, dev))
rows.update(cs.fused_kernel_phase(cfg, staged, cams, dev, aabb))
rows.update(cs.bwd_kernel_phase(cfg, params, tree, dev))
rows.update(cs.coords_kernel_phase(cfg, params, tree, dev))
for name, rs in cs.width_kernel_phase(cfg, dev).items():
    rows[name] += rs
del params, staged
torch.cuda.empty_cache()
_bounds, cases = cs.fwd_step_bounds(tree, dev)
rows["bilerp_fwd_unpacked"] += cs.fwd_step_phase(cases)
del cases
for name, rs in rows.items():
    by_order = {}
    for r in rs:
        order = r.get("order", "random")
        key = f"width F={r['feat']}" if order == "width" else order
        o = by_order.setdefault(key, {"n": 0, "ms": 0.0, "bound_ms": 0.0,
                                      "max_abs_err": 0.0})
        o["n"] += 1
        o["ms"] += r["ms"]
        o["bound_ms"] += r["bound_ms"]
        o["max_abs_err"] = max(o["max_abs_err"], r["max_abs_err"])
    out[name] = by_order
    out[name + " cases"] = [[r["case"][:60], r["ms"], r["bound_ms"]] for r in rs]

gen = torch.Generator(device=dev).manual_seed(7)
h, w, m = 300, 256, 1_000_003
hashes = {}
for feat in (8, 32):
    planes = [torch.rand((h, w, feat), generator=gen, device=dev).to(torch.bfloat16)
              for _ in range(3)]
    rowids = [torch.randint(0, h * w, (m,), generator=gen, device=dev,
                            dtype=torch.int32) for _ in range(3)]
    txs = [torch.rand(m, generator=gen, device=dev) for _ in range(3)]
    ty = torch.rand(m, generator=gen, device=dev)
    pts = torch.rand((m, 4), generator=gen, device=dev) * 2.2 - 1.1
    unpacked = [p.reshape(h * w, feat).contiguous() for p in planes]
    packed = [quad_pack(p).contiguous() for p in planes]
    outs = {
        "unpacked": pk.bilerp_fwd_unpacked(unpacked, rowids, txs, ty, h=h, w=w),
        "packed": pk.bilerp_fwd_packed(packed, rowids, txs, ty),
        "fused": [pk.kplanes_fwd_fused(
            pts, [unpacked[0], packed[1], packed[2]],
            [(0, 1, h, w), (0, 3, h, w), (2, 3, h, w)],
            torch.empty((m, feat), device=dev))],
    }
    for kind, o in outs.items():
        digest = hashlib.sha256(b"".join(t.cpu().numpy().tobytes() for t in o))
        hashes[f"{kind} F={feat}"] = digest.hexdigest()[:16]
out["hashes"] = hashes
print("TURN " + json.dumps(out), flush=True)
"""


def main() -> int:
    for tree in sys.argv[1:]:
        proc = subprocess.run([sys.executable, "-c", TURN, str(HARNESS)],
                              cwd=tree, capture_output=True, text=True)
        line = [ln for ln in proc.stdout.splitlines() if ln.startswith("TURN ")]
        if proc.returncode != 0 or not line:
            print(proc.stdout[-3000:], proc.stderr[-3000:])
            return 1
        print(json.dumps({"tree": tree, **json.loads(line[0][5:])}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
