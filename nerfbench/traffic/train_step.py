"""train_step: the program's ``TrainStep.train_iteration`` in a closed loop
on the cell's batches, each of ``rays`` random (ring camera, pixel, frame)
with random target colours, drawn from the seed at set-up into a pool on
the device that the window cycles through, so that the host's batch making
does not pace the step.

Set-up makes the configuration's weights from the seed, builds one
``TrainStep`` and its state at step 10,000, where the window runs (the
proposal weights' anneal is done, and a proposal update comes every
sixth step), and drives that state through its first ``FIRST_STEPS``
steps with the window's own call and pool, the first a proposal update
step and the others not, as the window's steps are: the reference
follows those steps.  It then runs ``warmup_steps`` more (every shape of
the window) and moves the state back to step 10,000 and the start of
the update cycle: every window starts at the same point.

What is compared, once the window has closed and the program's state is
freed: each compared step's loss; the first gradient of every leaf as
the optimizer got it (from Adam's second moment after one update); and
every leaf's change over the three steps (taken before the fourth moves
it; leaves whose reference gradient is under a thousandth of the median
leaf's, which move by round-off alone, left out).  Each by its worst
step or leaf.  The optimizer's own count starts at 0 on both sides, as a
fresh optimizer's does: its schedule's warm-up sets the learning rates,
0 on the first step, and the window goes on from there.
"""
from __future__ import annotations

import statistics
import time

import torch

from nerfbench.harness import cell as C
from nerfbench.harness import compare, faults, port, scene, spec, tracing

FIRST_STEPS = 3
WINDOW_STEP = 10_000
B2 = 0.999


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def grouped(tree_by_group: dict, lists: dict) -> dict:
    """{group/path: tensor} of per-group leaf lists in the program's
    leaf order."""
    out = {}
    for group, values in lists.items():
        paths = [p for p, _t in compare.named_leaves(tree_by_group[group])]
        out.update({f"{group}/{p}": v for p, v in zip(paths, values)})
    return out


def first_since(cfg: dict) -> int:
    """Steps since the last proposal update that make the first compared
    step an update step at step 10,000."""
    return cfg["config"]["proposal_update_every"]


def setup(ctx):
    """The program's step, state, pool and generator, driven through the
    first steps; returns them with the record of those steps."""
    dev = torch.device(ctx.device)
    cfg, ref = ctx.cfg, ctx.reference
    cam = ctx.param("camera")
    table = scene.train_table(dev, cam["height"], cam["width"], cam["focal"])
    rays = ctx.param("rays")
    pool = scene.batch_pool(ctx.seed, ctx.param("pool"), rays, table, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(scene.seeded(ctx.seed, 2))
    step = port.train_step(cfg, port.model_config(cfg), table.port_cameras(dev), dev)
    if ctx.fault:
        faults.break_train_step(step, ctx.fault)
    state = step.init_state(ref.make_params(cfg, ctx.seed, dev))
    state.step, state.steps_since_update = WINDOW_STEP, first_since(cfg)
    record = {"draw_states": [], "losses": []}
    for i in range(FIRST_STEPS):
        record["draw_states"].append(gen.get_state())
        m = step.train_iteration(state, pool[i], gen)
        record["losses"].append(m["Train Loss"])
        if i == 0:
            # Adam's second moment after one update is (1 - b2) g^2
            nu = grouped(state.params, {g: [torch.sqrt(n.double().sum() / (1.0 - B2))
                                            for n in o.nu]
                                        for g, o in state.opt_state.items()})
            record["grad"] = nu
    start = ref.make_params(cfg, ctx.seed, dev)
    record["change"] = {
        f"{g}/{p}": (t.detach() - s).double().norm()
        for g in start
        for (p, t), (_q, s) in zip(compare.named_leaves(state.params[g]),
                                   compare.named_leaves(start[g]))}
    del start
    record["losses"] = torch.stack(record["losses"]).cpu().tolist()
    record["grad"] = {k: float(v) for k, v in record["grad"].items()}
    record["change"] = {k: float(v) for k, v in record["change"].items()}
    state.step, state.steps_since_update = WINDOW_STEP, 0
    for i in range(ctx.param("warmup_steps")):
        step.train_iteration(state, pool[(FIRST_STEPS + i) % len(pool)], gen)
    sync(dev)
    port.release_flags(dev)
    state.step, state.steps_since_update = WINDOW_STEP, 0
    return step, state, pool, gen, table, record


def reference_readings(ctx, record, pool, table, dtype=torch.float32) -> dict:
    """The reference's first steps from the seed's weights at step 10,000,
    on the same batches and draws, the proposal networks trained on the
    steps that the configuration's schedule says: losses, first gradient
    norms, changes."""
    dev = torch.device(ctx.device)
    cfg, ref = ctx.cfg, ctx.reference
    updates = ref.proposal_updates(cfg["config"], WINDOW_STEP, first_since(cfg), FIRST_STEPS)
    params = ref.requires_grad(ref.make_params(cfg, ctx.seed, dev))
    adam = ref.Adam(cfg, params)
    gen = torch.Generator(device=dev)
    losses = []
    for i in range(FIRST_STEPS):
        gen.set_state(record["draw_states"][i])
        batch = pool[i]
        d = ref.draws(cfg, batch["cam_idx"].shape[0], gen, dev)
        c2w, fx, fy, cx, cy, times = table.per_ray(batch["cam_idx"])
        r = ref.rays(c2w, fx, fy, cx, cy, times, batch["coords"])
        loss, grads = ref.train_step(cfg, params, adam, r, batch["image"], WINDOW_STEP + i,
                                     d, cams=batch["cam_idx"], dtype=dtype,
                                     update_proposals=updates[i])
        losses.append(loss)
        if i == 0:
            grad = compare.norms(
                (f"{g}/{p}", torch.zeros_like(t) if gr is None else gr)
                for g in grads
                for (p, t), gr in zip(compare.named_leaves(params[g]), grads[g]))
        del grads
    start = ref.make_params(cfg, ctx.seed, dev)
    change = compare.norms(
        (f"{g}/{p}", t.detach() - s)
        for g in start
        for (p, t), (_q, s) in zip(compare.named_leaves(params[g]),
                                   compare.named_leaves(start[g])))
    return {"losses": torch.stack(losses).cpu().tolist(), "grad": grad, "change": change}


def numbers(program: dict, reference: dict) -> dict:
    """loss_gap: the worst first step's relative loss gap; grad_gap and
    change_gap: the worst leaf's gap of norms (compare.worst_leaf_gap),
    the change over the leaves that the reference's first gradient
    moves."""
    loss_gap = max(compare.relative_gap(p, r)
                   for p, r in zip(program["losses"], reference["losses"]))
    grad_gap, grad_leaf = compare.worst_leaf_gap(program["grad"], reference["grad"])
    floor = 1e-3 * statistics.median(reference["grad"].values())
    moved = [k for k, v in reference["grad"].items() if v >= floor]
    change_gap, change_leaf = compare.worst_leaf_gap(program["change"], reference["change"],
                                                     moved)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap,
            "_grad_leaf": grad_leaf, "_change_leaf": change_leaf,
            "_left_out": sorted(set(reference["grad"]) - set(moved))}


def traced_work(ctx, snapshot, gen_state, batches, flags, table) -> dict:
    """The traced steps' counts (the configuration's work module: model
    FLOPs, the least bytes of its lookups or gradients), from each step's
    sample points, which the reference works out from the same batches
    and draws at the parameters of the window's start."""
    dev = torch.device(ctx.device)
    cfg, ref = ctx.cfg, ctx.reference
    work = spec.work(cfg)
    gen = torch.Generator(device=dev)
    gen.set_state(gen_state)
    total: dict = {}
    with torch.no_grad():
        for j, (batch, update) in enumerate(zip(batches, flags)):
            n = batch["cam_idx"].shape[0]
            d = ref.draws(cfg, n, gen, dev)
            o, dirs, t = ref.rays(*table.per_ray(batch["cam_idx"]), batch["coords"])
            out = ref.forward(cfg, snapshot, o, dirs, t, batch["cam_idx"], train=True,
                              step=WINDOW_STEP + j, jitters=d["jitters"],
                              background=d["background"], keep_points=True)
            counter = work.Counter(cfg["config"], dev, ref)
            for lv, pts in enumerate(out["points"]):
                counter.add(lv, pts)
            part = work.unit_work(cfg["config"], counter, n, train=True, update=update)
            total = {k: total.get(k, 0.0) + v for k, v in part.items()}
    return total


def run(ctx) -> dict:
    from torch.profiler import record_function

    dev = torch.device(ctx.device)
    step, state, pool, gen, table, record = setup(ctx)
    rays = ctx.param("rays")
    setup_s = C.process_seconds()

    spans = tracing.Spans()
    losses = []
    k = FIRST_STEPS + ctx.param("warmup_steps")
    t0 = time.perf_counter()
    while True:
        m = spans.timed("train_iteration", step.train_iteration, state,
                        pool[k % len(pool)], gen)
        losses.append(m["Train Loss"])
        k += 1
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    sync(dev)
    elapsed = time.perf_counter() - t0
    port.release_flags(dev)
    steps = len(losses)
    failed = int((~torch.isfinite(torch.stack(losses))).sum())
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    window = host_window = None
    if ctx.trace:
        snapshot = clone_tree(state.params)
        gen_state = gen.get_state()
        n_traced = ctx.param("trace_units")
        batches = [pool[(k + j) % len(pool)] for j in range(2 * n_traced)]
        flags = []

        def traced(part):
            def steps():
                for batch in part:
                    with record_function("nerfbench.train_iteration"):
                        step.train_iteration(state, batch, gen)
                    flags.append(state.steps_since_update == 0)
                return len(part)
            return steps

        window = tracing.trace(traced(batches[:n_traced]), dev)
        host_window = tracing.trace(traced(batches[n_traced:]), dev, host=True)
        port.release_flags(dev)
        del state, step
        window.spans_ms = spans.ms
        window.unit_seconds = elapsed / steps
        window.work = traced_work(ctx, snapshot, gen_state, batches[:n_traced],
                                  flags[:n_traced], table)
        del snapshot
    else:
        del state, step
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    ref_readings = reference_readings(ctx, record, pool, table)
    nums = numbers(record, ref_readings)
    checks = C.checks_of(nums, ctx.cell["limits"])
    e2e = {"train_rays_per_s": (rays * steps / elapsed, "rays/s"),
           "setup_s": (setup_s, "s")}
    return C.result_line(ctx, attempted=steps, failed=failed, e2e=e2e, checks=checks,
                         memory_peak=peak, window=window, host_window=host_window,
                         extra={"window": {
                             "steps": steps, "seconds": elapsed,
                             "host_ms_quartiles": statistics.quantiles(spans.ms["train_iteration"], n=4)
                             if steps > 1 else None},
                                "worst_leaves": {"grad": nums["_grad_leaf"],
                                                 "change": nums["_change_leaf"],
                                                 "change_left_out": nums["_left_out"]}})


def clone_tree(tree):
    """A detached copy of a parameter tree."""
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [clone_tree(v) for v in tree]
    return tree.detach().clone()


def control(ctx, record, pool, table) -> dict:
    """The control's numbers: the reference in bf16 put in the program's
    place, against the reference."""
    low = reference_readings(ctx, record, pool, table, dtype=torch.bfloat16)
    return numbers(low, reference_readings(ctx, record, pool, table))

