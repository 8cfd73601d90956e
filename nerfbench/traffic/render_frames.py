"""render_frames: whole images through the program's render entry
(``engine.render.render_camera``, as ``snt-render`` and ``snt-eval`` call
it through ``Trainer.render_camera``: every output copied to the host) in
a closed loop over the ring's cameras at frames stepping through the time
axis, from a frame the seed picks.  A frame is complete when its outputs
are on the host.

What is compared, once the window has closed and the program's weights
are freed: ``check_frames`` of the completed frames and ``check_pixels``
pixels of each, drawn from the seed, against the reference's render of
the same pixels (images.numbers).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from nerfbench.harness import cell as C
from nerfbench.harness import faults, images, port, scene, tracing


def run(ctx) -> dict:
    from torch.profiler import record_function

    dev = torch.device(ctx.device)
    cfg, ref = ctx.cfg, ctx.reference
    cam = ctx.param("camera")
    table = scene.render_table(dev, cam["height"], cam["width"], cam["focal"])
    cams = table.port_cameras(dev)
    mcfg = port.model_config(cfg)
    params = ref.make_params(cfg, ctx.seed, dev)
    render = port.render
    if ctx.fault:
        render = faults.break_render(render, ctx.fault)
    start = ctx.seed % scene.FRAMES

    def frame(i):
        k = (start + i) % scene.FRAMES
        return k, render(cfg, mcfg, params, cams, k, dev)

    for i in range(ctx.param("warmup_frames")):
        frame(i)
    setup_s = C.process_seconds()

    frames = []
    t0 = time.perf_counter()
    while True:
        frames.append(frame(len(frames)))
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    elapsed = time.perf_counter() - t0
    pixels = cam["height"] * cam["width"]
    failed = sum(not images.finite(out) for _k, out in frames)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    window = host_window = None
    if ctx.trace:
        n_traced = ctx.param("trace_units")
        done = []

        def traced():
            for _ in range(n_traced):
                with record_function("nerfbench.render_camera"):
                    done.append(frame(len(frames) + len(done))[0])
            return n_traced

        window = tracing.trace(traced, dev)
        host_window = tracing.trace(traced, dev, host=True)
        total = {}
        for k in done[:n_traced]:
            pose = table.c2w[k].cpu().numpy()
            total = images.add_work(total, images.frame_work(
                ctx, params, pose, float(table.times[k]), cam))
        window.work = total
        window.unit_seconds = elapsed / len(frames)
    del params
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    nums = check(ctx, table, cam, frames)
    checks = C.checks_of(nums, ctx.cell["limits"])
    e2e = {"render_rays_per_s": (pixels * len(frames) / elapsed, "rays/s"),
           "setup_s": (setup_s, "s")}
    return C.result_line(ctx, attempted=len(frames), failed=failed, e2e=e2e,
                         checks=checks, memory_peak=peak, window=window,
                         host_window=host_window,
                         extra={"window": {"frames": len(frames), "seconds": elapsed}})


def sample(ctx, frames):
    """(frame positions, per frame the flat pixel indices) drawn from the
    seed among the completed frames."""
    cam = ctx.param("camera")
    rng = np.random.default_rng(scene.seeded(ctx.seed, 3))
    n = min(ctx.param("check_frames"), len(frames))
    chosen = sorted(rng.choice(len(frames), size=n, replace=False).tolist())
    pixels = cam["height"] * cam["width"]
    count = min(ctx.param("check_pixels"), pixels)
    return chosen, [torch.as_tensor(rng.choice(pixels, size=count, replace=False))
                    for _ in chosen]


def check(ctx, table, cam, frames, control: bool = False) -> dict:
    """The compared numbers of the sampled frames' pixels: the program's
    outputs (``control``: the reference's in bf16 in their place) against
    the reference's."""
    params = ctx.reference.make_params(ctx.cfg, ctx.seed, torch.device(ctx.device))
    chosen, pixel_sets = sample(ctx, frames)
    prog, refs = [], []
    for pos, pix in zip(chosen, pixel_sets):
        k, out = frames[pos]
        pose, time_ = table.c2w[k].cpu().numpy(), float(table.times[k])
        refs.append(images.reference_pixels(ctx, params, pose, time_, cam, pix))
        prog.append(images.reference_pixels(ctx, params, pose, time_, cam, pix,
                                            dtype=torch.bfloat16) if control
                    else images.pixels_of(out, pix))
    return images.numbers(prog, refs)
