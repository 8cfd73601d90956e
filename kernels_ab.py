#!/usr/bin/env python3
"""Per-call times of the plane kernels at the main paths' widths (F = 8 and
32) of checkouts of this repository in turns, on one CUDA card, to compare
two versions (run them as P C C P).

Each argument is the root of a checkout (``.`` for this one); each turn
runs in a fresh process from that checkout, with its own
``soccernerfs_tpu_torch`` and ``chip_smoke.py``, and runs chip_smoke's
plane kernel phases on the registry's k-planes (weights from numpy seed
0): the forward kernels on random points, the fused render kernel on a
frame's captured launches, the backward kernels on random points and on
one train step's launches.  It prints one JSON line per turn: the build's
seconds, per kernel the ``kernels`` line's sum (the random cases; the
fused kernel's frame launches) and the backward kernels' train-step sum,
and the sha256 of the forward kernels' outputs at F = 8 and 32 on seeded
operands (equal hashes across checkouts: bit-equal results).

Usage (from any directory; needs CUDA):
    python3 kernels_ab.py PARENT_TREE . . PARENT_TREE
"""
import json
import subprocess
import sys

TURN = r"""
import hashlib, json, sys, time
import torch
sys.path.insert(0, ".")
import chip_smoke as cs
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
for name, rs in rows.items():
    rs = [r for r in rs if r.get("order") != "width"]
    base = [r for r in rs if r.get("order", "random") == "random"] or rs
    out[name] = {"ms": sum(r["ms"] for r in base),
                 "max_abs_err": max(r["max_abs_err"] for r in base),
                 "step_ms": sum(r["ms"] for r in rs if r.get("order") == "ray")}

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
        proc = subprocess.run([sys.executable, "-c", TURN], cwd=tree,
                              capture_output=True, text=True)
        line = [ln for ln in proc.stdout.splitlines() if ln.startswith("TURN ")]
        if proc.returncode != 0 or not line:
            print(proc.stdout[-3000:], proc.stderr[-3000:])
            return 1
        print(json.dumps({"tree": tree, **json.loads(line[0][5:])}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
