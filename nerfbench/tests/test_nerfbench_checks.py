"""The comparison refuses what it has to: a run of the harness at a small
size on the CPU (its look for a chip skipped), sound, then with the timed
path broken underneath, and the control (the reference in bf16 in the
program's place) against the cells' limits."""
import pytest

from nerfbench.harness import cell as C
from nerfbench.harness import faults, scene, spec
from nerfbench.tests.tiny import tiny
from nerfbench.traffic import render_frames, train_step, view_loop

SEED = 3_000_000_017


@pytest.mark.parametrize("name", ["kplanes-train", "kplanes-render", "npnerfacto-train",
                                  "kplanes-view"])
def test_a_sound_run_is_correct(name):
    line = C.run_cell(name, SEED, 0.5, False, "cpu", overrides=tiny(name))
    assert line["correct"], line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {m["name"] for m in spec.workload(name)["end_to_end"]}
    assert "setup_s" in line["metrics"]


@pytest.mark.parametrize("name,fault", [(c, f) for c in ("kplanes-train", "npnerfacto-train")
                                        for f in faults.TRAIN]
                         + [("kplanes-render", f) for f in faults.RENDER]
                         + [("kplanes-view", f) for f in faults.RENDER])
def test_a_broken_timed_path_is_not_correct(name, fault):
    line = C.run_cell(name, SEED, 0.5, False, "cpu", overrides=tiny(name), fault=fault)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("name", ["kplanes-train", "npnerfacto-train"])
def test_the_train_control_is_refused(name):
    ctx = C.context(name, SEED, "cpu", tiny(name))
    _step, _state, pool, _gen, table, record = train_step.setup(ctx)
    nums = train_step.control(ctx, record, pool, table)
    checks = C.checks_of(nums, ctx.cell["limits"])
    assert not all(c.ok for c in checks), nums


@pytest.mark.parametrize("name", ["kplanes-render", "kplanes-view"])
def test_the_render_control_is_refused(name):
    ctx = C.context(name, SEED, "cpu", tiny(name))
    if name == "kplanes-render":
        cam = ctx.param("camera")
        table = scene.render_table("cpu", cam["height"], cam["width"], cam["focal"])
        nums = render_frames.check(ctx, table, cam, [(k, None) for k in range(3)],
                                   control=True)
    else:
        done = [(scene.orbit_pose(k), None) for k in range(3)]
        nums = view_loop.check(ctx, done, control=True)
    assert not all(c.ok for c in C.checks_of(nums, ctx.cell["limits"])), nums


@pytest.mark.parametrize("name", ["kplanes-train", "npnerfacto-train"])
def test_a_traced_run_reads_its_metrics_on_the_cpu(name):
    line = C.run_cell(name, SEED, 0.5, True, "cpu", overrides=tiny(name))
    assert line["correct"]
    # the CPU has no device operations: the launches and the idle share
    # find nothing to read and are left out
    kind = "train_kplanes" if name == "kplanes-train" else "train_hash"
    assert {f"host_ms_per_step.{kind}", f"mfu.{kind}"} <= set(line["metrics"])
    assert set(line["metrics"]) <= {m["name"] for m in spec.workload(name)["per_layer"]}
    assert "breakdown" in line and line["device"]["window_s"] > 0
