#!/usr/bin/env python3
"""Drive the PyTorch port (soccernerfs_tpu_torch) on one CUDA card and check it.

  1. Prints the card's name and power limit (nvidia-smi).
  2. Builds the CUDA kernels from soccernerfs_tpu_torch/csrc with nvcc.
  3. Kernel phase: at the render path's shapes, holds each kernel against
     its plain PyTorch version (relative max error <= 1e-5) and times it
     with CUDA events beside the plain version and, as a yardstick,
     torch.nn.functional.grid_sample(align_corners=True,
     padding_mode="border") on the same points.
  4. Render phase: the full ``k-planes`` model with weights drawn from a
     numpy seed, loaded through ``params_from_jax``; renders two 960x540
     frames (two cameras at two times) with ``render_camera`` and fails
     unless both kernels launched during them.  Then times two more frames
     and traces one with torch.profiler.
  5. CPU check: one 4096-ray chunk through the same model on the CPU
     (the kernels' plain versions) against the card.

Prints a JSON line with the kernels' results, the card line, and last
``{"ok": true, "device": {...}}``.  Any failure exits non-zero before the
last line.  Needs CUDA and this repository around it.

Usage (from the repository root):
    python3 chip_smoke.py [--trace DIR]
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
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


XZ_YZ = ([(0, 1), (1, 3)], 2)              # [(c1, plane index)], c2
XT_YT_ZT = ([(0, 2), (1, 4), (2, 5)], 3)


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


def kernel_phase(cfg, staged, dev):
    from soccernerfs_tpu_torch.ops.grid_sample import grid_coords
    from soccernerfs_tpu_torch.ops.kernels import plane_kernels as pk

    gen = torch.Generator(device=dev).manual_seed(SEED)
    results = {"bilerp_fwd_unpacked": [], "bilerp_fwd_packed": []}
    for label, kind, params, s, h, w, members, c2, m in kernel_cases(cfg, staged):
        pts = torch.rand((m, 4), generator=gen, device=dev) * 2.0 - 1.0
        tables = [params["grids_packed"][s][ci] for _c1, ci in members]
        planes = [params["grids"][s][ci] for _c1, ci in members]
        yc, ty = grid_coords(pts[:, c2], h)
        rowids, txs = [], []
        for c1, _ci in members:
            xc, tx = grid_coords(pts[:, c1], w)
            rowids.append(yc * w + xc)
            txs.append(tx)
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

        got = kern()
        want = plain()
        torch.cuda.synchronize()
        err = max(float((g - e).abs().max()) for g, e in zip(got, want))
        scale = max(float(e.abs().max()) for e in want)
        if not err <= KERNEL_REL_TOL * scale:
            raise AssertionError(f"{kind} {label}: max |kernel - plain| = "
                                 f"{err} > {KERNEL_REL_TOL} * {scale}")
        del got, want

        # grid_sample yardstick: the same bf16 plane values as f32 NCHW, the
        # same continuous coordinates
        inp = torch.stack([p.to(torch.bfloat16).float().permute(2, 0, 1)
                           for p in planes])
        grid = torch.stack([pts[:, [c1, c2]] for c1, _ci in members])[:, None]

        def library():
            return torch.nn.functional.grid_sample(
                inp, grid, mode="bilinear", padding_mode="border",
                align_corners=True)

        lib_out = library()[:, :, 0].permute(0, 2, 1)
        lib_err = max(float((g - e).abs().max())
                      for g, e in zip(kern(), lib_out))
        del lib_out

        ms = time_ms(kern, 20)
        plain_ms = time_ms(plain, 5)
        library_ms = time_ms(library, 10)
        n = len(members)
        bytes_ = group_bytes(m, feat, tables)
        flops = m * (1 + n * (9 * feat + 1))   # 1-ty; 1-tx and 9 per feature
        t_bytes = bytes_ / H100_BYTES_PER_S * 1e3
        t_ops = flops / H100_F32_FLOPS * 1e3
        row = {
            "case": label, "planes": n, "M": m, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "library_max_abs_diff": lib_err, "bytes": bytes_, "flops": flops,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        }
        log("kernel", kind, json.dumps(row))
        results[f"bilerp_fwd_{kind}"].append(row)
        del pts, rowids, txs, ty, inp, grid
        torch.cuda.empty_cache()
    return results


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


def profile_frame(render, trace_dir):
    """Device time by kernel over one frame; busy share of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        render()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if trace_dir:
        Path(trace_dir).mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(Path(trace_dir) / "render_frame_trace.json"))
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
    plane_us = sum(r[0] for r in rows if "bilerp_fwd" in r[2])
    # one stream: kernels do not overlap, so their sum is the busy time
    log(f"profile: wall {wall * 1e3:.3f} ms (profiled), device kernel time "
        f"{total_us / 1e3:.3f} ms, busy share "
        + (f"{total_us / 1e6 / wall:.4f}, plane-kernel share "
           f"{plane_us / total_us:.4f}" if total_us else "not measured"))
    for dev_us, count, key in rows[:15]:
        log(f"profile: {dev_us / 1e3:10.3f} ms {count:6d}x  {key[:90]}")
    # device time of each plane kernel in the frame (template <F, packed>)
    return {
        name: sum(r[0] for r in rows
                  if "bilerp_fwd_kernel<" in r[2] and flag in r[2]) / 1e3
        for name, flag in (("bilerp_fwd_unpacked", ", false>"),
                           ("bilerp_fwd_packed", ", true>"))
    }


def frame_plane_bound_ms(cfg, staged, n_chunks):
    """Least time the plane kernels of one frame could take, per kernel:
    ``group_bytes`` of every launch of every chunk (the planes of a scale
    grouped as interpolate_kplanes groups them; times given, so all six
    planes) at the card's memory rate."""
    from soccernerfs_tpu_torch.fields.kplanes import (plane_combinations,
                                                      plane_groups)

    planes = [(ci, c1, c2) for ci, (c1, c2) in enumerate(plane_combinations(4))]
    chunk = cfg.eval_num_rays_per_chunk
    levels = [
        (staged["proposal_networks"][f"proposal_{idx}"],
         chunk * cfg.num_proposal_samples_per_ray[it])
        for it, (idx, _d) in enumerate(cfg.density_field_configs())
    ]
    levels.append((staged["fields"], chunk * cfg.num_nerf_samples_per_ray))
    total = {"bilerp_fwd_unpacked": 0, "bilerp_fwd_packed": 0}
    for params, m in levels:
        for grids, staged_tables in zip(params["grids"], params["grids_packed"]):
            for members in plane_groups(planes, grids).values():
                tables = [staged_tables[ci] for ci, _c1 in members]
                feat = grids[members[0][0]].shape[-1]
                kind = "unpacked" if tables[0].shape[-1] == feat else "packed"
                total[f"bilerp_fwd_{kind}"] += group_bytes(m, feat, tables)
    return {k: v * n_chunks / H100_BYTES_PER_S * 1e3 for k, v in total.items()}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--trace", default=None,
                        help="directory for a chrome trace of one frame")
    args = parser.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    import soccernerfs_tpu_torch

    if Path(soccernerfs_tpu_torch.__file__).resolve().parents[1] != HERE:
        print("chip_smoke: soccernerfs_tpu_torch is not beside this script",
              file=sys.stderr)
        return 1
    from soccernerfs_tpu_torch.configs.method_configs import model_configs
    from soccernerfs_tpu_torch.convert import params_from_jax, seeded_params
    from soccernerfs_tpu_torch.core.cameras import generate_rays
    from soccernerfs_tpu_torch.engine.render import render_camera
    from soccernerfs_tpu_torch.models import kplanes
    from soccernerfs_tpu_torch.ops.kernels import build
    from soccernerfs_tpu_torch.ops.kernels import plane_kernels as pk

    dev = torch.device(DEVICE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log("card:", card)
    log("torch", torch.__version__, "cuda", torch.version.cuda,
        "python", sys.version.split()[0])

    t0 = time.perf_counter()
    lib = build.build("plane_kernels")
    log(f"build: {time.perf_counter() - t0:.3f} s, {lib.name}")
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            log("ptxas:", line.strip())

    cfg = model_configs[MODEL]
    t0 = time.perf_counter()
    tree = seeded_params(cfg, SEED, time_noise=0.05)
    params = params_from_jax(tree, device=dev)
    staged = kplanes.prepare_render_params(cfg, params)
    torch.cuda.synchronize()
    n_params = sum(int(np.prod(a.shape)) for a in _leaves(tree))
    log(f"params: {n_params} ({n_params * 4 / 2**20:.1f} MiB f32), made and "
        f"staged in {time.perf_counter() - t0:.3f} s")

    kernels = kernel_phase(cfg, staged, dev)

    aabb = torch.tensor([[-1.5] * 3, [1.5] * 3], device=dev)
    cams = make_cameras(dev)

    # the main path, counted: two whole frames
    pk.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frames = [render_camera(cfg, staged, cams, i, device=dev, aabb=aabb) for i in (0, 1)]
    torch.cuda.synchronize()
    first_two_s = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in pk.KERNELS}
    log(f"render: 2 frames {W}x{H} in {first_two_s:.3f} s (first frames), "
        f"launches {launches}")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"{name} was not launched by the render path")
    for i, fr in enumerate(frames):
        rgb, depth, acc = fr["rgb"], fr["depth"], fr["accumulation"]
        assert rgb.shape == (H, W, 3) and depth.shape == (H, W), (rgb.shape, depth.shape)
        assert acc.shape == (H, W)
        for k, v in fr.items():
            assert bool(torch.isfinite(v).all()), f"frame {i} {k} not finite"
        assert float(rgb.min()) >= 0.0 and float(rgb.max()) <= 1.0
        assert float(acc.min()) >= 0.0 and float(acc.max()) <= 1.0 + 1e-4
        log(f"frame {i}: rgb mean {float(rgb.mean()):.6f}, acc mean "
            f"{float(acc.mean()):.6f}, depth mean {float(depth.mean()):.6f}")

    # steady-state frame time
    times = []
    for i in (0, 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        render_camera(cfg, staged, cams, i, device=dev, aabb=aabb)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    per_frame = sum(times) / len(times)
    log(f"render: steady {per_frame:.4f} s/frame ({times}), "
        f"{H * W / per_frame:.1f} test rays/s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    pk.reset_launch_counts()
    in_frame = profile_frame(
        lambda: render_camera(cfg, staged, cams, 1, device=dev, aabb=aabb),
        args.trace)
    per_frame_launches = {k.__name__: k.launches for k in pk.KERNELS}
    log(f"launches per frame {per_frame_launches}")
    n_chunks = -(-H * W // cfg.eval_num_rays_per_chunk)
    for name, bound in frame_plane_bound_ms(cfg, staged, n_chunks).items():
        log(f"in-frame {name}: {in_frame[name]:.3f} ms device, bound "
            f"{bound:.3f} ms (bytes)"
            + (f", {bound / in_frame[name]:.4f} of bound" if in_frame[name] else ""))

    # CPU check: the same model on the CPU (plain versions), one chunk
    pix = np.linspace(0, H * W - 1, 4096).astype(np.int64)
    coords = np.stack([pix // W, pix % W], -1).astype(np.float32) + 0.5
    cpu = torch.device("cpu")
    params_cpu = kplanes.prepare_render_params(
        cfg, params_from_jax(tree, device=cpu))
    outs = {}
    for where, d, p in (("card", dev, staged), ("cpu", cpu, params_cpu)):
        rays = generate_rays(cams.to(d), torch.zeros(4096, dtype=torch.int32,
                                                     device=d),
                             torch.from_numpy(coords).to(d))
        with torch.no_grad():
            o = kplanes.get_outputs(cfg, p, aabb.to(d), rays)
        outs[where] = {k: o[k].cpu() for k in ("rgb", "accumulation", "depth")}
    diffs = {k: float((outs["card"][k] - outs["cpu"][k]).abs().max())
             for k in outs["cpu"]}
    depth_rel = ((outs["card"]["depth"] - outs["cpu"]["depth"]).abs()
                 / outs["cpu"]["depth"].abs().clamp(min=1e-6))
    depth_off = float((depth_rel > 1e-3).float().mean())
    log(f"cpu check (4096 rays): max |card - cpu| {diffs}, depth rays off by "
        f">1e-3 rel: {depth_off}")
    # rgb/accumulation are continuous in every input: 2e-3 covers f32
    # reduction-order differences through the MLPs and the PDF resampling;
    # the median depth jumps where the cumulative weight sits at 0.5
    if diffs["rgb"] > 2e-3 or diffs["accumulation"] > 2e-3 or depth_off > 0.01:
        raise AssertionError(f"card and CPU disagree: {diffs}, {depth_off}")

    replaces = {
        "bilerp_fwd_unpacked": "soccernerfs_tpu/ops/pallas/plane_kernels.py:591",
        "bilerp_fwd_packed": "soccernerfs_tpu/ops/pallas/plane_kernels.py:1062",
    }
    summary = []
    for name, rows in kernels.items():
        t_bytes = sum(r["bytes"] for r in rows) / H100_BYTES_PER_S * 1e3
        t_ops = sum(r["flops"] for r in rows) / H100_F32_FLOPS * 1e3
        summary.append({
            "name": name, "route": "cuda",
            "source": "soccernerfs_tpu_torch/csrc/plane_kernels.cu",
            "replaces": replaces[name],
            "launches": launches[name],
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


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    sys.exit(main())
