"""The plain reference against the port's CPU path at a small size: one
training step's loss terms and gradients, and a rendered image."""
import numpy as np
import pytest
import torch

from nerfbench.harness import cell as C
from nerfbench.harness import compare, port, scene
from nerfbench.tests.tiny import tiny


@pytest.fixture()
def ctx():
    return C.context("kplanes-train", 2**31 + 12345, "cpu", tiny("kplanes-train"))


@pytest.mark.parametrize("at,update", [(0, True), (10_000, False)])
@pytest.mark.parametrize("cell", ["kplanes-train", "npnerfacto-train"])
def test_one_training_step_matches_the_port(cell, at, update):
    """At step 0 every level trains; at 10,000, on a step without a
    proposal update, the proposal fields run without a gradient (the
    program's in-place path) and the weights' anneal is done."""
    ctx = C.context(cell, 2**31 + 12345, "cpu", tiny(cell))
    ref, cfg = ctx.reference, ctx.cfg
    table = scene.train_table("cpu", 27, 48, 40.0)
    batch = scene.batch_pool(ctx.seed, 1, 64, table, "cpu")[0]
    step = port.train_step(cfg, port.model_config(cfg), table.port_cameras("cpu"), "cpu")
    state = step.init_state(ref.make_params(cfg, ctx.seed, "cpu"))
    state.step = at
    gen = torch.Generator().manual_seed(7)
    draws = ref.draws(cfg, 64, gen, "cpu")
    loss, terms, _m, grads = step.loss_and_grads(
        state, batch, train_proposal_networks=update, jitters=draws["jitters"],
        background=draws["background"], tv_rows=draws.get("tv_rows"))
    params = ref.requires_grad(ref.make_params(cfg, ctx.seed, "cpu"))
    r = ref.rays(*table.per_ray(batch["cam_idx"]), batch["coords"])
    out = ref.forward(cfg, params, *r, batch["cam_idx"], train=True, step=at,
                      jitters=draws["jitters"], background=draws["background"],
                      update_proposals=update)
    ref_terms = (ref.loss_terms(cfg, params, out, batch["image"], draws["tv_rows"])
                 if "tv_rows" in draws else ref.loss_terms(cfg, params, out, batch["image"]))
    assert set(ref_terms) == set(terms)
    for k in terms:
        assert float(terms[k]) == pytest.approx(float(ref_terms[k].detach()), rel=1e-5,
                                                abs=1e-9), k
    total = sum(ref_terms.values())
    ref_grads = torch.autograd.grad(total, [p for _n, p in compare.named_leaves(params)],
                                    allow_unused=True)
    assert float(loss) == pytest.approx(float(total), rel=1e-6)
    # each leaf's gradient within 1e-4 of the larger of its norm and the
    # median leaf's (f32 sums in another order; bf16 roundings that flip)
    median = float(torch.stack([rg.norm() for rg in ref_grads if rg is not None]).median())
    for (name, _p), g, rg in zip(compare.named_leaves(params), grads, ref_grads):
        g = torch.zeros(1) if g is None else g
        rg = torch.zeros(1) if rg is None else rg
        assert float((g - rg).norm()) <= 1e-4 * max(float(rg.norm()), median), name


def test_a_rendered_image_matches_the_port(ctx):
    ref, cfg = ctx.reference, ctx.cfg
    cam = {"height": 27, "width": 48, "focal": 40.0}
    table = scene.render_table("cpu", 27, 48, 40.0)
    params = ref.make_params(cfg, ctx.seed, "cpu")
    out = port.render(cfg, port.model_config(cfg), params, table.port_cameras("cpu"), 3, "cpu")
    from nerfbench.harness import images

    pix = torch.arange(27 * 48)
    mine = images.reference_pixels(ctx, params, table.c2w[3].numpy(), float(table.times[3]),
                                   cam, pix)
    for k in ("rgb", "accumulation", "depth"):
        np.testing.assert_allclose(out[k].reshape(mine[k].shape).numpy(), mine[k].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_adam_and_schedule_match_the_port(ctx):
    from soccernerfs_tpu_torch.engine import optimizers as O

    ref, cfg = ctx.reference, ctx.cfg
    groups = port.optimizer_configs(cfg)
    sched = O.schedule_fn(groups["fields"]["scheduler"], 0.01)
    for count in (0, 1, 511, 512, 9000, 40000):
        assert ref.schedule(cfg["optimizers"]["fields"]["scheduler"], count) == \
            pytest.approx(float(sched(count)), rel=1e-7)
    g = torch.Generator().manual_seed(3)
    p_prog = {"fields": [torch.rand(5, 3, generator=g)], "proposal_networks": [torch.rand(4)]}
    p_ref = {k: [t.clone() for t in v] for k, v in p_prog.items()}
    states = {k: O.adam_init(groups[k]["optimizer"], v) for k, v in p_prog.items()}
    adam = ref.Adam(cfg, p_ref)
    for _ in range(4):
        grads = {k: [torch.randn(t.shape, generator=g) for t in v] for k, v in p_prog.items()}
        for k in p_prog:
            O.group_update(groups[k]["optimizer"],
                           O.schedule_fn(groups[k]["scheduler"], groups[k]["optimizer"].lr),
                           states[k], p_prog[k], grads[k])
        adam.step(grads)
    for k in p_prog:
        for a, b in zip(p_prog[k], p_ref[k]):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("config", ["k-planes", "nerfplayer-nerfacto"])
def test_the_proposal_update_schedule_matches_the_port(config):
    from soccernerfs_tpu_torch.models import kplanes

    from nerfbench.harness import spec

    c = spec.config(config)["config"]
    mcfg = port.model_config(spec.config(config))
    for start, since in [(0, 0), (7, 0), (2_000, 1), (4_990, 3), (10_000, 0), (10_000, 5)]:
        host, program = {"steps_since_update": since}, []
        for s in range(start, start + 40):
            program.append(kplanes.host_static_kwargs(mcfg, s, host)["train_proposal_networks"])
        assert spec.reference(config).proposal_updates(c, start, since, 40) == program
    # the compared steps of a train cell: an update step, then two without
    assert spec.reference(config).proposal_updates(c, 10_000, c["proposal_update_every"], 3) \
        == [True, False, False]
