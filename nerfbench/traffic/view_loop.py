"""view_loop: one viewer client in a closed loop.  Each request hands the
program's render entry the next pose of an orbit that moves 1 degree round
the ring and one frame on per request (from a point the seed picks), and
waits for the image's outputs on the host; its latency runs from the pose
to the outputs on the host.  The chunk is the viewer's.

What is compared, once the window has closed and the program's weights
are freed: ``check_frames`` of the completed requests, drawn from the
seed, ``check_pixels`` pixels each, against the reference
(images.numbers).
"""
from __future__ import annotations

import time

import torch

from nerfbench.harness import cell as C
from nerfbench.harness import faults, images, port, scene, tracing
from nerfbench.traffic import render_frames


def run(ctx) -> dict:
    from torch.profiler import record_function

    dev = torch.device(ctx.device)
    cfg, ref = ctx.cfg, ctx.reference
    cam = ctx.param("camera")
    chunk = ctx.param("chunk")
    mcfg = port.model_config(cfg)
    params = ref.make_params(cfg, ctx.seed, dev)
    render = port.render
    if ctx.fault:
        render = faults.break_render(render, ctx.fault)
    start = ctx.seed % 360

    def request(i):
        pose, t = scene.orbit_pose(start + i)
        out = render(cfg, mcfg, params, port.camera(pose, t, cam, dev), 0, dev, chunk)
        return (pose, t), out

    for i in range(ctx.param("warmup_frames")):
        request(i)
    setup_s = C.process_seconds()

    done, latency = [], []
    t0 = time.perf_counter()
    while True:
        r0 = time.perf_counter()
        done.append(request(len(done)))
        latency.append((time.perf_counter() - r0) * 1e3)
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    elapsed = time.perf_counter() - t0
    failed = sum(not images.finite(out) for _p, out in done)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    window = host_window = None
    if ctx.trace:
        n_traced = ctx.param("trace_units")
        traced_done = []

        def traced():
            for _ in range(n_traced):
                with record_function("nerfbench.view_request"):
                    traced_done.append(request(len(done) + len(traced_done)))
            return n_traced

        window = tracing.trace(traced, dev)
        host_window = tracing.trace(traced, dev, host=True)
        window.unit_seconds = elapsed / len(done)
    del params
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    nums = check(ctx, done)
    checks = C.checks_of(nums, ctx.cell["limits"])
    e2e = {"view_ms_p95": (tracing.p95(latency), "ms"), "setup_s": (setup_s, "s")}
    return C.result_line(ctx, attempted=len(done), failed=failed, e2e=e2e, checks=checks,
                         memory_peak=peak, window=window, host_window=host_window,
                         extra={"window": {"requests": len(done),
                                           "median_ms": float(sorted(latency)[len(latency) // 2])}})


def check(ctx, done, control: bool = False) -> dict:
    """The sampled requests' pixels against the reference's (``control``:
    the reference's in bf16 in the program's place)."""
    cam = ctx.param("camera")
    params = ctx.reference.make_params(ctx.cfg, ctx.seed, torch.device(ctx.device))
    chosen, pixel_sets = render_frames.sample(ctx, done)
    prog, refs = [], []
    for pos, pix in zip(chosen, pixel_sets):
        (pose, t), out = done[pos]
        refs.append(images.reference_pixels(ctx, params, pose, t, cam, pix))
        prog.append(images.reference_pixels(ctx, params, pose, t, cam, pix,
                                            dtype=torch.bfloat16) if control
                    else images.pixels_of(out, pix))
    return images.numbers(prog, refs)
