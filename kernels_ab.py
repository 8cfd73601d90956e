#!/usr/bin/env python3
"""Per-call times of the plane and sampler kernels of checkouts of this
repository in turns, on one CUDA card, to compare two versions (run them
as P C C P).

Each argument is the root of a checkout (``.`` for this one); each turn
runs in a fresh process with that checkout's ``soccernerfs_tpu_torch``
(built there) and this checkout's ``chip_smoke.py`` as the harness, so
every turn measures the same cases the same way and only the kernels
differ.  On the registry's k-planes (weights from numpy seed 0) it runs
chip_smoke's plane kernel phases: the per-plane forward kernels on random
points at the render path's point counts and ``bilerp_fwd_unpacked`` at
the train path's (262,144 points) ("kernel"); the fused render kernel on
a frame's captured launches ("fused"); the table backward kernels on
random points and one train step's launches ("bwd");
``bilerp_bwd_coords`` on random points and on one SO3xR3 step's launches
("coords"); every plane kernel at F = 16, 20, 24 and 48 ("width"); both
per-plane forward kernels on the launches of one train step, captured at
the wrapper ("step"); the train forward of kp_res_study's finest scale,
staging and kernels, as the checkout's field runs it ("kpres"); the
packed kernel's wide cases with the points' rows folded into L2
(``l2_probe_phase``, "l2"); and the two staged layouts of a plane table
under
the train forward and the render path, per width and plane shape
(``layout_phase``, "layout"); the importance sampler's two kernels on
chip_smoke's step, single-map and full-HD cases ("sampler").  Each case is
held against its plain version as chip_smoke holds it.

It prints one JSON line per turn: the build's seconds; per kernel and
case order (random, train, ray: a step's launches, width: per F; the
sampler's step, single and full) the
cases' count, summed ms and byte bound, and the largest error against
the plain version; per layout case [F, h, w, planes, then for the
unpacked and the packed layout the train forward's ms (staging and
kernel), the staging's, the kernel's and the render launch's]; the
kp_res_study forward's ms a step and launches; the sha256 of the forward
kernels' outputs at F = 8, 24 and 32 on seeded operands, and with
"sampler" of each sampler case's CDFs and draws (equal hashes across
checkouts: bit-equal results), beside an empty kernel's launch time.

Usage (from any directory; needs CUDA):
    python3 kernels_ab.py [--phases kernel,step,...] PARENT_TREE . . PARENT_TREE
"""
import inspect
import json
import statistics
import time
import subprocess
import sys
from pathlib import Path

import torch

HARNESS = Path(__file__).resolve().parent / "chip_smoke.py"

TURN = r"""
import hashlib, importlib.util, json, sys, time
import torch
sys.path.insert(0, ".")
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
spec = importlib.util.spec_from_file_location("kernels_ab", sys.argv[3])
kab = importlib.util.module_from_spec(spec)
spec.loader.exec_module(kab)
from soccernerfs_tpu_torch.ops.grid_sample import quad_pack
from soccernerfs_tpu_torch.ops.kernels import build, plane_kernels as pk, scatter_kernels as sk
from soccernerfs_tpu_torch.ops.kernels import sampler_kernels as spk

t0 = time.perf_counter()
build.build_all([*pk.LIBRARIES, *sk.LIBRARIES, *spk.LIBRARIES])
out = {"build_s": time.perf_counter() - t0}
dev = torch.device("cuda")
aabb = torch.tensor(cs.AABB, device=dev)
cams = cs.make_cameras(dev)
_module, cfg, _camera_optimizer = cs.method_parts(cs.MODEL)
phases = sys.argv[2].split(",")
if set(phases) - {"sampler"}:
    tree, params, staged = cs.make_params(cs.MODEL, dev, time_noise=0.05)
else:                                   # the sampler's phase needs no model
    tree = params = staged = None
rows = {k.__name__: [] for k in (*pk.KERNELS, *spk.KERNELS)}
if "sampler" in phases:
    # a checkout from before the launch floor has no empty kernel: its
    # rows' floor_ms are then a no-op's and are not reported
    has_floor = hasattr(spk, "empty_launch")
    if not has_floor:
        spk.empty_launch = lambda device: None
    sampler = cs.sampler_kernel_phase(dev)
    rows.update(sampler)
    out["sampler_floor_ms"] = sampler["cdf_draw"][0]["floor_ms"] if has_floor else None
    out["sampler_hashes"] = {
        f"{r['order']} {key}": r[key + "_sha256"]
        for r in sampler["cdf_draw"] for key in ("cdf", "draws")}
if "kernel" in phases:
    rows.update(cs.kernel_phase(cfg, staged, dev))
if "fused" in phases:
    rows.update(cs.fused_kernel_phase(cfg, staged, cams, dev, aabb))
if "bwd" in phases:
    rows.update(cs.bwd_kernel_phase(cfg, params, tree, dev))
if "coords" in phases:
    rows.update(cs.coords_kernel_phase(cfg, params, tree, dev))
if "width" in phases:
    for name, rs in cs.width_kernel_phase(cfg, dev).items():
        rows[name] += rs
del params, staged
torch.cuda.empty_cache()
if "step" in phases:
    _bounds, cases = cs.fwd_step_bounds(tree, dev)
    for name, rs in cs.fwd_step_phase(cases).items():
        rows[name] += rs
    del cases
if "l2" in phases:
    out["l2_probe"] = kab.l2_probe_phase(cs, cfg, dev)
if "kpres" in phases:
    out["kp_res_forward"] = kab.kp_res_forward_phase(cs, cfg, dev)
if "cpu" in phases:
    out["cpu_route"] = kab.cpu_route_phase(cs, cfg)
if "layout" in phases:
    out["layout"] = [
        [r["feat"], r["h"], r["w"], r["planes"]]
        + [round(r[lay][k], 4) for lay in ("unpacked", "packed")
           for k in ("train_ms", "stage_ms", "kernel_ms", "render_ms")]
        for r in kab.layout_phase(cs, cfg, dev)]
for name, rs in rows.items():
    if not rs:
        continue
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
for feat in (8, 24, 32):
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


# the staged layouts' cases (layout_phase): every width of the registry and
# the sweeps, on the registered k-planes' field planes (64^2 .. 1024^2
# space, [100, 64 .. 1024] time) and kp_res_study's finest ([100, 2048],
# 2048^2), below and above the 50 MB L2
LAYOUT_FEATS = (8, 16, 24, 32, 48)
LAYOUT_SHAPES = ((64, 64), (128, 128), (256, 256), (1024, 1024), (2048, 2048),
                 (100, 64), (100, 128), (100, 256), (100, 512), (100, 1024),
                 (100, 2048))


def layout_table(plane, packed):
    """An [h, w, F] plane's bf16 table, F compiled: the checkout's
    ops/grid_sample.stage_table in the layout asked for; a checkout whose
    stage_table picks the layout itself (bb590d8) gets the same two
    layouts from its quad_pack."""
    from soccernerfs_tpu_torch.ops import grid_sample as gs

    if "packed" in inspect.signature(gs.stage_table).parameters:
        return gs.stage_table(plane, packed)
    table = plane.to(torch.bfloat16)
    if packed:
        return gs.quad_pack(table).contiguous()
    return table.reshape(-1, table.shape[-1]).contiguous()


def ray_points(rays, samples, gen, dev):
    """[rays * samples, 4] points in [-1, 1]^4 in ray order: each ray's
    samples evenly spaced from one uniform space point to another at one
    uniform time, as a step's or a chunk's samples come."""
    ends = torch.rand((2, rays, 1, 3), generator=gen, device=dev) * 2.0 - 1.0
    frac = torch.linspace(0.0, 1.0, samples, device=dev)[None, :, None]
    space = ends[0] + (ends[1] - ends[0]) * frac
    times = (torch.rand((rays, 1, 1), generator=gen, device=dev) * 2.0 - 1.0
             ).expand(rays, samples, 1)
    return torch.cat([space, times], -1).reshape(rays * samples, 4).contiguous()


def layout_phase(cs, cfg, dev):
    """The two staged layouts of a plane table, [h*w, F] unpacked and
    [h*w, 4F] quad-packed (the same bf16 values), under both users of
    ops/grid_sample.stage_table, per width of LAYOUT_FEATS and plane shape
    of LAYOUT_SHAPES: a group of planes sharing y (three [100, w] time
    planes, XT YT ZT; two square space planes, XZ YZ), random values,
    ray-ordered points (ray_points).  The train forward (_FoldGroup, at the
    train path's 4096 rays x 64 samples) stages the f32 planes and
    launches its per-plane kernel every step: timed staged and launched
    together, and each part alone.  The render path (kplanes_fwd_fused, at
    a chunk's points) stages once a snapshot: its launch alone.  Each
    user's two layouts must give bit-equal outputs.  Returns the rows,
    "order": "layout"."""
    from soccernerfs_tpu_torch.configs.method_configs import train_num_rays_per_batch
    from soccernerfs_tpu_torch.ops.kernels import plane_kernels as pk

    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 3)
    samples = cfg.num_nerf_samples_per_ray
    pts_train = ray_points(train_num_rays_per_batch[cs.MODEL], samples, gen, dev)
    pts_render = ray_points(cfg.eval_num_rays_per_chunk, samples, gen, dev)
    stage = {"unpacked": lambda p: layout_table(p, False),
             "packed": lambda p: layout_table(p, True)}
    rows = []
    for feat in LAYOUT_FEATS:
        for h, w in LAYOUT_SHAPES:
            members, c2 = cs.XT_YT_ZT if h != w else cs.XZ_YZ
            planes = [0.1 + 0.4 * torch.rand((h, w, feat), generator=gen,
                                             device=dev) for _ in members]
            rowids, txs, ty, _grid, _library = cs.group_sampler(
                planes, pts_train, members, c2)
            descs = [(c1, c2, h, w) for c1, _ci in members]
            out = torch.empty((pts_render.shape[0], feat), device=dev)
            row = {"order": "layout", "feat": feat, "h": h, "w": w,
                   "planes": len(members)}
            got = {}
            for layout, fn in stage.items():
                tables = [fn(p) for p in planes]
                if layout == "unpacked":
                    def kern():
                        return pk.bilerp_fwd_unpacked(tables, rowids, txs, ty,
                                                      h=h, w=w)
                else:
                    def kern():
                        return pk.bilerp_fwd_packed(tables, rowids, txs, ty)

                def train():
                    nonlocal tables
                    tables = [fn(p) for p in planes]
                    return kern()

                def render():
                    return pk.kplanes_fwd_fused(pts_render, tables, descs, out)

                got[layout] = ([t.clone() for t in kern()],
                               render().clone())
                row[layout] = {
                    "table_mb": sum(t.numel() * 2 for t in tables) / 1e6,
                    "train_ms": cs.time_ms(train, 20),
                    "stage_ms": cs.time_ms(lambda: [fn(p) for p in planes], 20),
                    "kernel_ms": cs.time_ms(kern, 20),
                    "render_ms": cs.time_ms(render, 20),
                }
                del tables
            (train_u, render_u), (train_p, render_p) = got.values()
            if not (all(torch.equal(a, b) for a, b in zip(train_u, train_p))
                    and torch.equal(render_u, render_p)):
                raise AssertionError(f"layouts F = {feat} [{h},{w}]: the two "
                                     f"layouts' outputs differ")
            for user in ("train", "render"):
                u, pkd = row["unpacked"][f"{user}_ms"], row["packed"][f"{user}_ms"]
                row[f"{user}_faster"] = "unpacked" if u <= pkd else "packed"
            cs.log("layout", json.dumps(row))
            rows.append(row)
            del planes, rowids, txs, ty, out, got
            torch.cuda.empty_cache()
    return rows


def field_groups(grids, pts, reso):
    """A K-Planes scale's six planes grouped by y axis and width as
    fields/kplanes.interpolate_kplanes groups them, at points ``pts``
    [M, 4] in [-1, 1]: per group (grids, rowids, txs, ty), the arguments
    of plane_sample_fold_group."""
    from soccernerfs_tpu_torch.fields.kplanes import plane_combinations, plane_groups
    from soccernerfs_tpu_torch.ops.grid_sample import grid_coords

    planes = [(ci, c1, c2) for ci, (c1, c2) in enumerate(plane_combinations(4))]
    groups = []
    for (c2, w), members in plane_groups(planes, grids).items():
        h = grids[members[0][0]].shape[0]
        yc, ty = grid_coords(pts[:, c2], h)
        rowids, txs = [], []
        for _ci, c1 in members:
            xc, tx = grid_coords(pts[:, c1], w)
            rowids.append(yc * w + xc)
            txs.append(tx)
        groups.append(([grids[ci] for ci, _c1 in members], rowids, txs, ty))
    return groups


def scale_grids(reso, feat, gen, dev):
    """A scale's six [reso[c2], reso[c1], feat] planes, random values."""
    from soccernerfs_tpu_torch.fields.kplanes import plane_combinations

    return [0.1 + 0.4 * torch.rand((reso[c2], reso[c1], feat), generator=gen,
                                   device=dev)
            for c1, c2 in plane_combinations(4)]


def kp_res_forward_phase(cs, cfg, dev, feat=24, res=2048, time_res=100):
    """The train forward of kp_res_study's finest scale (its F = 24 run:
    three [res, res] space planes and three [time_res, res] time planes)
    as the checkout's field runs it each step: each group of field_groups
    through plane_sample_fold_group (stage_table's staging and the
    per-plane forward kernel it picks) at the train path's ray-ordered
    points (4096 rays x 64 samples).  Returns the median of BWD_PASSES
    passes of 20 (ms a step) and the launches by kernel of one pass."""
    from soccernerfs_tpu_torch.configs.method_configs import train_num_rays_per_batch
    from soccernerfs_tpu_torch.ops.grid_sample import plane_sample_fold_group

    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 4)
    pts = ray_points(train_num_rays_per_batch[cs.MODEL], cfg.num_nerf_samples_per_ray,
                     gen, dev)
    reso = (res, res, res, time_res)
    groups = field_groups(scale_grids(reso, feat, gen, dev), pts, reso)

    def step():
        with torch.no_grad():
            return [plane_sample_fold_group(*g) for g in groups]

    cs.reset_launch_counts()
    step()
    torch.cuda.synchronize()
    counts = {k: v for k, v in cs.launch_counts().items() if v}
    ms = statistics.median(cs.time_ms(step, 20) for _ in range(cs.BWD_PASSES))
    cs.log(f"kp_res forward F = {feat}: {len(groups)} groups of [{res},{res}] and "
        f"[{time_res},{res}] planes, staging and kernels {ms:.4f} ms a step, "
        f"launches {counts}")
    return {"ms": ms, "launches": counts}


def cpu_route_phase(cs, cfg, threads=8):
    """The train path's plane sampling on CPU tensors, as chip_smoke's
    train CPU checks run it (the kernels' plain versions): the registered
    k-planes' five field scales (64^2 .. 1024^2 space planes, [100, 64 ..
    1024] time planes, F = 32, random values) at TRAIN_CPU_RAYS ray-ordered
    rays x 64 samples, every group through plane_sample_fold_group, forward
    and backward into the grids, and again with the fractions' gradients
    (the camera optimizer's steps).  Host clock, ``threads`` torch
    threads, the best of 3.  Returns {"fwd_bwd_s", "fwd_bwd_coords_s"}."""
    from soccernerfs_tpu_torch.ops.grid_sample import plane_sample_fold_group

    saved = torch.get_num_threads()
    torch.set_num_threads(threads)
    gen = torch.Generator().manual_seed(cs.SEED + 5)
    cpu = torch.device("cpu")
    pts = ray_points(cs.TRAIN_CPU_RAYS, cfg.num_nerf_samples_per_ray, gen, cpu)
    base = cfg.spacetime_resolution
    scales = []
    for mult in cfg.multiscale_res:
        reso = (*(r * mult for r in base[:3]), base[3])
        grids = [g.requires_grad_() for g in scale_grids(reso, 32, gen, cpu)]
        scales.append(field_groups(grids, pts, reso))

    def step(coords):
        loss = 0.0
        for groups in scales:
            for grids, rowids, txs, ty in groups:
                txs = [t.clone().requires_grad_(coords) for t in txs]
                ty = ty.clone().requires_grad_(coords)
                loss = loss + sum(o.sum() for o in plane_sample_fold_group(
                    grids, rowids, txs, ty))
        loss.backward()

    out = {}
    try:
        for key, coords in (("fwd_bwd_s", False), ("fwd_bwd_coords_s", True)):
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                step(coords)
                times.append(time.perf_counter() - t0)
            out[key] = min(times)
    finally:
        torch.set_num_threads(saved)
    cs.log(f"cpu route: {json.dumps(out)}")
    return out


def l2_probe_phase(cs, cfg, dev, feats=(16, 24, 48)):
    """Why a packed width case runs under its byte bound: the packed
    kernel on width_kernel_phase's operands (three quad-packed [100, 2048]
    planes, past the 50 MB L2, uniform random points) timed as they are
    and with every row id folded into the tables' first rows (row % R/16:
    the rows the points touch then fit in L2), the same points, tables,
    instructions and output bytes; the difference is what the gathers'
    L2 misses cost (a stand-in for a profiler's L2 hit rate).
    Returns {F: {"ms", "confined_ms", "table_mb"}}."""
    from soccernerfs_tpu_torch.ops.kernels import plane_kernels as pk

    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 2)
    m = cfg.eval_num_rays_per_chunk * cfg.num_nerf_samples_per_ray
    h, w = cs.WIDTH_PLANES
    members, c2 = cs.XT_YT_ZT
    out = {}
    for feat in feats:
        planes = [0.1 + 0.4 * torch.rand((h, w, feat), generator=gen, device=dev)
                  for _ in members]
        pts = torch.rand((m, 4), generator=gen, device=dev) * 2.0 - 1.0
        rowids, txs, ty, _grid, _library = cs.group_sampler(planes, pts, members, c2)
        tables = [layout_table(p, True) for p in planes]
        folded = [r % (h * w // 16) for r in rowids]
        row = {
            "ms": cs.time_ms(lambda: pk.bilerp_fwd_packed(tables, rowids, txs, ty), 20),
            "confined_ms": cs.time_ms(
                lambda: pk.bilerp_fwd_packed(tables, folded, txs, ty), 20),
            "table_mb": sum(t.numel() * 2 for t in tables) / 1e6,
        }
        cs.log(f"l2 probe F = {feat}: " + json.dumps(row))
        out[feat] = row
        del planes, pts, rowids, txs, ty, tables, folded
        torch.cuda.empty_cache()
    return out


PHASES = ("kernel", "fused", "bwd", "coords", "width", "step", "kpres",
          "layout", "l2", "cpu", "sampler")


def main() -> int:
    args = sys.argv[1:]
    phases = PHASES
    if args[:1] == ["--phases"]:
        phases, args = tuple(args[1].split(",")), args[2:]
        if not set(phases) <= set(PHASES):
            raise SystemExit(f"phases are some of {','.join(PHASES)}")
    for tree in args:
        proc = subprocess.run([sys.executable, "-c", TURN, str(HARNESS),
                               ",".join(phases), str(Path(__file__).resolve())],
                              cwd=tree, capture_output=True, text=True)
        line = [ln for ln in proc.stdout.splitlines() if ln.startswith("TURN ")]
        if proc.returncode != 0 or not line:
            print(proc.stdout[-3000:], proc.stderr[-3000:])
            return 1
        print(json.dumps({"tree": tree, **json.loads(line[0][5:])}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
