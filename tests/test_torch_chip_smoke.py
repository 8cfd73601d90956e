"""chip_smoke.py's control flow, rehearsed on the CPU at a small size.

The script needs a card; here its CUDA calls are stubbed, the kernel
wrappers are made to count their plain versions as launches, and small
K-Planes, nerfacto, semantic-nerfw, nerfplayer-nerfacto, nerfplayer,
instant-ngp-bounded, nerfplayer-ngp, nerfplayer-ngp-complete,
k-planes-static, tensorf, vanilla-nerf (dnerf), mipnerf and neus configs
stand in for the full widths (the NeRF fields keep theirs over a few
samples), so every phase (the
plane and scatter kernel checks, and per method two counted frames, the
render CPU comparison, the counted train steps, the train CPU comparison;
the Trainer phases on tiny fixtures with a few steps, the exporter's five
subcommands at small resolutions; the JSON lines) runs in a minute or two.
Also checks that, without CUDA, the script exits non-zero and prints no
result, both from the repository and alone in a directory.
"""
import copy
import dataclasses
import importlib.util
import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from soccernerfs_tpu_torch.configs import method_configs as mc
from soccernerfs_tpu_torch.ops.kernels import build
from soccernerfs_tpu_torch.ops.kernels import plane_kernels as pk
from soccernerfs_tpu_torch.ops.kernels import scatter_kernels as sk


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch CPU thread while this file runs.  The suite runs in
    parallel worker processes; a full-width torch thread pool in each of
    them oversubscribes the cores, and its threads' spin-waiting then slows
    these many small ops by two orders of magnitude."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


REPO = Path(__file__).resolve().parents[1]


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Event:
    def __init__(self, **_):
        self.t = 0.0

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


def test_chip_smoke_phases_on_cpu(monkeypatch, capsys, tmp_path):
    cs = _load_chip_smoke()
    small = dataclasses.replace(
        mc.model_configs["k-planes"],
        spacetime_resolution=(16, 16, 16, 8), multiscale_res=(1, 16),
        proposal_net_args_list=(
            {"feature_dim": 8, "resolution": (16, 16, 16, 8)},
            {"feature_dim": 8, "resolution": (32, 32, 32, 8)},
        ),
        num_proposal_samples_per_ray=(16, 8), num_nerf_samples_per_ray=8,
        eval_num_rays_per_chunk=512,
    )
    small_nerfacto = dataclasses.replace(
        mc.model_configs["nerfacto"], num_levels=4, max_res=64,
        log2_hashmap_size=13, hidden_dim=16, hidden_dim_color=16,
        proposal_net_args_list=(
            {"hidden_dim": 8, "log2_hashmap_size": 12, "num_levels": 3, "max_res": 32},
            {"hidden_dim": 8, "log2_hashmap_size": 12, "num_levels": 3, "max_res": 64},
        ),
        num_proposal_samples_per_ray=(16, 8), num_nerf_samples_per_ray=8,
        eval_num_rays_per_chunk=512,
    )
    small_nerfplayer = dataclasses.replace(
        mc.model_configs["nerfplayer-nerfacto"], num_levels=3,
        log2_hashmap_size=12, temporal_dim=8, hidden_dim=16,
        hidden_dim_color=16,
        proposal_net_args_list=(
            {"hidden_dim": 8, "temporal_dim": 6, "log2_hashmap_size": 11,
             "num_levels": 3, "max_res": 32},
            {"hidden_dim": 8, "temporal_dim": 6, "log2_hashmap_size": 11,
             "num_levels": 3, "max_res": 64},
        ),
        num_proposal_samples_per_ray=(16, 8), num_nerf_samples_per_ray=8,
        eval_num_rays_per_chunk=512,
    )
    occ = dict(grid_resolution=16, num_probes_per_ray=64,
               max_num_samples_per_ray=8, eval_num_rays_per_chunk=512)
    small_ingp = dataclasses.replace(
        mc.model_configs["instant-ngp-bounded"], log2_hashmap_size=12,
        max_res=64, **occ)
    small_npngp = dataclasses.replace(
        mc.model_configs["nerfplayer-ngp"], num_levels=3, temporal_dim=8,
        log2_hashmap_size=12, max_res=64, **occ)
    # the decomposition field: its stationary grid reads deformed points
    # outside the cube
    small_np = dataclasses.replace(
        mc.model_configs["nerfplayer"], num_levels=3, log2_hashmap_size=12,
        temporal_dim=8,
        proposal_net_args_list=small_nerfplayer.proposal_net_args_list,
        num_proposal_samples_per_ray=(16, 8), num_nerf_samples_per_ray=8,
        eval_num_rays_per_chunk=512)
    small_npngpc = dataclasses.replace(
        mc.model_configs["nerfplayer-ngp-complete"], num_levels=3,
        temporal_dim=8, log2_hashmap_size=12, **occ)
    small_depth = dataclasses.replace(
        mc.model_configs["depth-nerfacto"],
        **{f.name: getattr(small_nerfacto, f.name)
           for f in dataclasses.fields(small_nerfacto)})
    # the classic methods: TensoRF's tables at 16^3 growing to 24^3, the
    # NeRF fields at their registry width over a few samples
    small_tensorf = dataclasses.replace(
        mc.model_configs["tensorf"], init_resolution=16, final_resolution=24,
        upsampling_iters=(2, 4), num_den_components=4, num_color_components=6,
        num_uniform_samples=16, num_samples=8, eval_num_rays_per_chunk=512)
    nerf_samples = dict(num_coarse_samples=8, num_importance_samples=8,
                        eval_num_rays_per_chunk=512)
    small_vnerf = dataclasses.replace(mc.model_configs["vanilla-nerf"],
                                      **nerf_samples)
    small_mip = dataclasses.replace(mc.model_configs["mipnerf"], **nerf_samples)
    small_semantic = dataclasses.replace(
        mc.model_configs["semantic-nerfw"], num_semantic_classes=7,
        **{f.name: getattr(small_nerfacto, f.name)
           for f in dataclasses.fields(small_nerfacto)})
    # NeuS's sampler over the registry's planes (0.05 to 1000), a narrow
    # SDF field
    small_neus = dataclasses.replace(
        mc.model_configs["neus"], num_samples=8, num_samples_importance=8,
        eval_num_rays_per_chunk=512,
        sdf_field=dataclasses.replace(
            mc.model_configs["neus"].sdf_field, num_layers=3, hidden_dim=32,
            geo_feat_dim=16, num_layers_color=2, hidden_dim_color=16))
    for small_name, method, small_cfg in (("small", "k-planes", small),
                                          ("small-nerfacto", "nerfacto",
                                           small_nerfacto),
                                          ("small-depth", "depth-nerfacto",
                                           small_depth),
                                          ("small-nerfplayer",
                                           "nerfplayer-nerfacto",
                                           small_nerfplayer),
                                          ("small-ingp", "instant-ngp-bounded",
                                           small_ingp),
                                          ("small-npngp", "nerfplayer-ngp",
                                           small_npngp),
                                          ("small-np", "nerfplayer", small_np),
                                          ("small-npngpc",
                                           "nerfplayer-ngp-complete",
                                           small_npngpc),
                                          ("small-tensorf", "tensorf",
                                           small_tensorf),
                                          ("small-vnerf", "vanilla-nerf",
                                           small_vnerf),
                                          ("small-mip", "mipnerf", small_mip),
                                          ("small-dnerf", "dnerf", small_vnerf),
                                          ("small-semantic", "semantic-nerfw",
                                           small_semantic),
                                          ("small-neus", "neus", small_neus)):
        monkeypatch.setitem(mc.model_configs, small_name, small_cfg)
        for table in (mc.optimizer_configs, mc.model_names,
                      mc.camera_optimizer_configs):
            monkeypatch.setitem(table, small_name, table[method])
        monkeypatch.setitem(mc.train_num_rays_per_batch, small_name, 256)
    # the Trainer phases: the same small models behind the registered
    # datamanagers, and a small k-planes-static
    small_static = dataclasses.replace(
        mc.model_configs["k-planes-static"], **cs.CONVERGENCE_MODEL,
        proposal_net_args_list=(
            {"feature_dim": 8, "resolution": (16, 16, 16)},
            {"feature_dim": 8, "resolution": (32, 32, 32)},
        ), eval_num_rays_per_chunk=512)
    monkeypatch.setitem(mc.model_configs, "small-static", small_static)
    for table in (mc.optimizer_configs, mc.model_names,
                  mc.camera_optimizer_configs):
        monkeypatch.setitem(table, "small-static", table["k-planes-static"])
    monkeypatch.setitem(mc.train_num_rays_per_batch, "small-static", 256)
    for small_name, method in (("small", "k-planes"),
                               ("small-depth", "depth-nerfacto"),
                               ("small-ingp", "instant-ngp-bounded"),
                               ("small-static", "k-planes-static"),
                               ("small-tensorf", "tensorf"),
                               ("small-dnerf", "dnerf"),
                               ("small-semantic", "semantic-nerfw"),
                               ("small-neus", "neus")):
        tcfg = copy.deepcopy(mc.trainer_configs[method])
        tcfg.pipeline.model = mc.model_configs[small_name]
        tcfg.pipeline.datamanager.train_num_rays_per_batch = 256
        monkeypatch.setitem(mc.trainer_configs, small_name, tcfg)
    monkeypatch.setattr(cs, "STATIC", "small-static")
    # wide enough for the CLI phase's DynMetric boxes (the ball's, grown 7x
    # wide and 2.5x high) to hold SSIM's 11x11 window
    monkeypatch.setattr(cs, "TRAINER_FIXTURE", {"num_cameras": 4,
                                                "num_steps": 4, "h": 32,
                                                "w": 64})
    # 3 train cameras: the cache picks 2 time steps of them
    monkeypatch.setattr(cs, "TRAINER_DATA", {
        "train_num_images_to_sample_from": 6,
        "train_num_times_to_repeat_images": 4, "iters_to_start_is": 2})
    monkeypatch.setattr(cs, "TRAINER_LOOP", {
        **cs.TRAINER_LOOP, "max_num_iterations": 8, "steps_per_save": 4,
        "steps_per_eval_image": 4, "steps_per_eval_batch": 4})
    monkeypatch.setattr(cs, "TRAINER_LOG_STEPS", 2)
    monkeypatch.setattr(cs, "TRAINER_DEPTH_STEPS", 6)
    # 9 train frames, 1 eval
    monkeypatch.setattr(cs, "NERFSTUDIO_FIXTURE", {"num_frames": 10, "h": 24,
                                                   "w": 32})
    monkeypatch.setattr(cs, "TRAINER_KPLANES", {})
    monkeypatch.setattr(cs, "TRAINER_RESUME_TO", 12)
    monkeypatch.setattr(cs, "INGP_TRAINER_STEPS", 6)
    monkeypatch.setattr(cs, "CONVERGENCE_STEPS", 3)
    monkeypatch.setattr(cs, "CONVERGENCE_RAYS", 128)
    # 3 steps learn nothing: the rehearsal checks the flow; the card and
    # tests/test_torch_trainer.py::test_kplanes_static_converges check the
    # gate itself
    monkeypatch.setattr(cs, "CONVERGENCE_GATE", (-np.inf, -np.inf))
    monkeypatch.setattr(cs, "CLI_STEPS", 4)
    monkeypatch.setattr(cs, "CLI_RENDER_STEPS", 3)
    monkeypatch.setattr(cs, "VIEWER_SIZES", ((24, 16), (40, 24)))
    monkeypatch.setattr(cs, "TENSORF", "small-tensorf")
    monkeypatch.setattr(cs, "VNERF", "small-vnerf")
    monkeypatch.setattr(cs, "MIPNERF", "small-mip")
    monkeypatch.setattr(cs, "DNERF", "small-dnerf")
    monkeypatch.setattr(cs, "CLASSIC_CPU_RAYS", {"small-tensorf": 64,
                                                 "small-vnerf": 32,
                                                 "small-mip": 32})
    monkeypatch.setattr(cs, "CLASSIC_FRAMES", {
        "small-tensorf": cs.CLASSIC_FRAMES["tensorf"],
        "small-vnerf": cs.CLASSIC_FRAMES["vanilla-nerf"],
        "small-mip": cs.CLASSIC_FRAMES["mipnerf"]})
    monkeypatch.setattr(cs, "TENSORF_FIXTURE", {"num_frames": 3, "h": 16, "w": 16})
    monkeypatch.setattr(cs, "TENSORF_TRAINER_ITERS", (2, 4))
    monkeypatch.setattr(cs, "TENSORF_TRAINER_STEPS", 6)
    monkeypatch.setattr(cs, "HYPERNERF_FIXTURE", {"num_times": 4, "h": 12,
                                                  "w": 16})
    monkeypatch.setattr(cs, "HYPERNERF_STEPS", 4)
    monkeypatch.setattr(cs, "HYPERNERF_IST_FROM", 2)
    monkeypatch.setattr(cs, "DNERF_FIXTURE", {"num_frames": 3, "h": 16, "w": 16})
    monkeypatch.setattr(cs, "DNERF_STEPS", 2)
    monkeypatch.setattr(cs, "DNERF_RENDER_STEPS", 2)
    monkeypatch.setattr(cs, "SEMANTIC", "small-semantic")
    monkeypatch.setattr(cs, "NEUS", "small-neus")
    monkeypatch.setattr(cs, "NEUS_CPU_RAYS", 32)
    monkeypatch.setattr(cs, "SITCOMS_FIXTURE", {"num_cameras": 3, "h": 12,
                                                "w": 16})
    monkeypatch.setattr(cs, "SEMANTIC_TRAINER_STEPS", 4)
    monkeypatch.setattr(cs, "NEUS_CLI_STEPS", 2)
    monkeypatch.setattr(cs, "NEUS_FIXTURE", {"num_frames": 10, "h": 12, "w": 16})
    monkeypatch.setattr(cs, "NEUS_RENDER_STEPS", 2)
    monkeypatch.setattr(cs, "EXPORT_ARGS", {
        "pointcloud": ["--num-cameras", "2"], "cameras": [],
        "marching-cubes": ["--resolution", "12"],
        "tsdf": ["--resolution", "12", "--num-cameras", "2"],
        "poisson": ["--resolution", "16", "--num-cameras", "2"]})
    monkeypatch.setattr(cs, "MODEL", "small")
    monkeypatch.setattr(cs, "NERFACTO", "small-nerfacto")
    monkeypatch.setattr(cs, "DEPTH", "small-depth")
    monkeypatch.setattr(cs, "NERFPLAYER", "small-nerfplayer")
    monkeypatch.setattr(cs, "INGP", "small-ingp")
    monkeypatch.setattr(cs, "NPNGP", "small-npngp")
    monkeypatch.setattr(cs, "NP", "small-np")
    monkeypatch.setattr(cs, "NPNGPC", "small-npngpc")
    # every range check the script makes, by the function that makes it
    checks = []
    check = sk.raise_if_out_of_range
    monkeypatch.setattr(sk, "raise_if_out_of_range",
                        lambda device=None: (checks.append(
                            sys._getframe(1).f_code.co_name), check(device)))
    monkeypatch.setattr(cs, "TRAIN_CPU_RAYS", 64)
    monkeypatch.setattr(cs, "TRAIN_WINDOW", 12)
    monkeypatch.setattr(cs, "OCC_TRAIN_WINDOW", 16)
    monkeypatch.setattr(cs, "DEVICE", "cpu")
    monkeypatch.setattr(cs, "H", 24)
    monkeypatch.setattr(cs, "W", 40)
    monkeypatch.setattr(cs, "card_line", lambda: "stub card, 0 W")
    # a 256 MiB L2 flush per timed call is a card's concern, not a CPU's
    monkeypatch.setattr(cs, "_FLUSH", torch.empty(16, dtype=torch.uint8))
    monkeypatch.setattr(
        cs, "profile_device",
        lambda label, fn, trace_path: (fn(), {k.__name__: 1.0
                                              for k in cs.all_kernels()})[1])
    for name, value in (("is_available", lambda: True),
                        ("synchronize", lambda *a: None),
                        ("Event", _Event),
                        ("max_memory_allocated", lambda *a: 0),
                        ("reset_peak_memory_stats", lambda *a: None),
                        ("get_device_name", lambda *a: "stub"),
                        ("device_count", lambda: 1),
                        ("empty_cache", lambda: None)):
        monkeypatch.setattr(torch.cuda, name, value)
    libs = [tmp_path / f"lib{name}_stub.so"
            for name in (*pk.LIBRARIES, *sk.LIBRARIES)]
    for lib in libs:
        lib.with_suffix(".log").write_text("ptxas info    : Used 32 registers\n")
    monkeypatch.setattr(build, "build_all", lambda names: libs)
    monkeypatch.setattr(cs, "bwd_strip", lambda: 8)
    # the wrappers take the "kernel" branch, which runs the plain versions
    monkeypatch.setattr(pk, "_on_cpu", lambda ts: False)
    monkeypatch.setattr(pk, "_check", lambda ins, r, x, y, dtype: r[0].shape[0])
    plain = {
        "snt_bilerp_fwd_unpacked": lambda a, shape: pk.bilerp_fwd_unpacked_plain(
            *a, h=shape[0], w=shape[1]),
        "snt_bilerp_fwd_packed": lambda a, shape: pk.bilerp_fwd_packed_plain(*a),
        "snt_bilerp_bwd_unpacked": lambda a, shape: pk.bilerp_bwd_unpacked_plain(
            *a, h=shape[0], w=shape[1]),
        "snt_bilerp_bwd_packed": lambda a, shape: pk.bilerp_bwd_packed_plain(
            *a, rows=shape[0]),
    }

    def launch(name, ins, rowids, txs, ty, outs, m, feat, *shape):
        for o, r in zip(outs, plain[name]((ins, rowids, txs, ty), shape)):
            o.copy_(r)

    monkeypatch.setattr(pk, "_launch", launch)
    monkeypatch.setattr(pk, "_check_fused", lambda pts, tables, planes, out: None)
    monkeypatch.setattr(pk, "_launch_fused", pk.kplanes_fwd_fused_plain)
    monkeypatch.setattr(sk, "_on_cpu", lambda ts: False)
    monkeypatch.setattr(sk, "_check_cuda", lambda operands: None)
    monkeypatch.setattr(
        sk, "_launch",
        lambda g, idxs, ws, out, flag, points, groups, corners, c, rows, window:
        out.copy_(sk.scatter_add_rows_plain(g, idxs, ws, rows=rows)))
    monkeypatch.setattr(cs, "scatter_layout", lambda dev: {
        "strip": {c: 8 if c <= 2 else 4 for c in sk.CHANNELS},
        "threads": 1024, "sms": 132})
    monkeypatch.setattr(sys, "argv", ["chip_smoke.py"])

    assert cs.main() == 0
    lines = capsys.readouterr().out.strip().splitlines()
    # the backward kernels on the train step's own launches, beside their
    # random cases, and against the step's byte bound after the profile
    bwd = [{**json.loads(line.split(" ", 2)[2]),
            "kernel": "bilerp_" + line.split(" ", 2)[1]}
           for line in lines if line.startswith("kernel bwd_")]
    step = [r for r in bwd if r["order"] == "ray"]
    assert len(bwd) - len(step) == 5
    assert {r["planes"] for r in step} == {1, 2, 3}
    assert all(0 < r["vector_reductions"] and r["points_per_flush"] >= 1.0
               for r in bwd)
    # samples of a ray often share a cell of these small planes
    assert max(r["points_per_flush"] for r in step) > 1.0
    assert all(len(r["ms_passes"]) == cs.BWD_PASSES
               and r["ms"] == statistics.median(r["ms_passes"]) for r in bwd)
    in_step = [line for line in lines if line.startswith("in-step bilerp_bwd_")]
    assert [line.split(" (")[0] for line in in_step] == [
        "in-step bilerp_bwd_unpacked"] * 2 + ["in-step bilerp_bwd_packed"]
    assert all("of bound" in line for line in in_step)
    # the forward kernels against the captured step's byte bound, in both
    # kinds of step, with as many launches
    in_step = [line for line in lines if line.startswith("in-step bilerp_fwd_")]
    assert [line.split(" (")[0] for line in in_step] == [
        "in-step bilerp_fwd_unpacked"] * 2 + ["in-step bilerp_fwd_packed"] * 2
    assert all("of bound" in line and "launches, bound" in line
               for line in in_step)
    assert json.loads(lines[-1]) == {
        "ok": True, "device": {"platform": "gpu", "kind": "stub", "count": 1}}
    assert lines[-2] == "stub card, 0 W"
    kernels = json.loads(lines[-3])["kernels"]
    assert [k["name"] for k in kernels] == [
        k.__name__ for k in (*pk.KERNELS, *sk.KERNELS)]
    assert len(kernels) == 6
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
    for k in kernels:
        assert set(k) == keys
        assert k["launches"] > 0 and k["max_abs_err"] == 0.0
        assert k["bound_by"] == "bytes" and k["bound_ms"] > 0
        assert (REPO / k["source"]).is_file()
        assert (REPO / k["replaces"].split(":")[0]).is_file()
    # the line sums the random cases of the backward kernels, as before the
    # captured train-step launches were added
    for k in kernels[2:4]:
        random = [r for r in bwd if r["kernel"] == k["name"]
                  and r["order"] == "random"]
        assert k["bound_ms"] == pytest.approx(
            sum(r["bytes"] for r in random) / cs.H100_BYTES_PER_S * 1e3)
        assert k["ms"] == pytest.approx(sum(r["ms"] for r in random))
    # scatter_add_rows: random cases, then the 3 launches of one nerfacto,
    # one depth-nerfacto (for its in-step bound) and one
    # nerfplayer-nerfacto update step, the 6 of a nerfplayer
    # update step (the stationary grid's two, one per encode, the newness
    # and decomposition grids' and the proposal grids'), the one launch of
    # an instant-ngp-bounded and of a nerfplayer-ngp step and the 4 of a
    # nerfplayer-ngp-complete step captured at the wrapper (the temporal
    # grids' at width 1 over their flattened tables), each with its L2
    # reductions; the kernels line sums the random cases only
    scatter = [json.loads(line.split(" ", 2)[2]) for line in lines
               if line.startswith("kernel scatter_add_rows ")]
    ray = [r for r in scatter if r["order"] == "ray"]
    random = [r for r in scatter if r["order"] == "random"]
    assert len(random) == 8 and len(ray) == 24
    temporal = {"main": 1, "proposal_0": 1, "proposal_1": 1}
    decomposition = {"static": 2, "temporal": 1, "proposal_0": 1,
                     "proposal_1": 1}
    for method, widths, grids in (
            ("small-nerfacto", {}, ["main", "proposal_0", "proposal_1"]),
            ("small-depth", {}, ["main", "proposal_0", "proposal_1"]),
            ("small-semantic", {}, ["main", "proposal_0", "proposal_1"]),
            ("small-nerfplayer", temporal, ["main", "proposal_0", "proposal_1"]),
            ("small-np", decomposition, ["proposal_0", "proposal_1", "static",
                                         "static", "temporal", "temporal"]),
            ("small-ingp", {}, ["main"]), ("small-npngp", temporal, ["main"]),
            ("small-npngpc", decomposition, ["static", "static", "temporal",
                                             "temporal"])):
        mine = [r for r in ray if r["method"] == method]
        assert sorted(r["grid"] for r in mine) == grids
        assert all(f", c {widths.get(r['grid'], 2)}, " in r["case"]
                   for r in mine)
    assert all(r["l2_reductions"] > 0 and len(r["ms_passes"]) == cs.BWD_PASSES
               and r["ms"] == statistics.median(r["ms_passes"]) for r in scatter)
    assert all(r["updates_per_reduction"] >= 1.0 for r in ray)
    in_step = [line for line in lines if line.startswith("in-step scatter_add_rows")]
    methods = ["small-nerfacto", "small-nerfplayer", "small-np", "small-ingp",
               "small-npngp", "small-npngpc"]
    assert [line.split(" (")[1].split(":")[0] for line in in_step] == [
        f"{kind} step) {method}" for method in ["small-nerfacto", "small-depth",
                                                "small-semantic", *methods[1:]]
        for kind in ("update", "non-update")]
    assert all("of bound" in line for line in in_step)
    # launches per update and non-update step
    for line, n in zip(in_step, (3, 1, 3, 1, 3, 1, 3, 1, 6, 4, 1, 1, 1, 1, 4, 4)):
        assert f"in {n} launches" in line, (line, n)
    # the later methods render and train, and the deferred range check runs
    # where each train phase and CPU check reads a step's loss
    for method in methods[1:]:
        assert any(line.startswith(f"render {method}: steady") for line in lines)
        assert any(line.startswith(f"train {method}: window steps")
                   for line in lines)
        assert any(line.startswith(f"train cpu check {method}, seed 2 ")
                   for line in lines)
    main_path = json.loads(next(line for line in lines if line.startswith(
        "main-path launches:")).split(":", 1)[1])
    # at least one launch per counted step: step 0, steps 1-11, the window
    for method, window in (("small-nerfplayer", cs.TRAIN_WINDOW),
                           ("small-np", cs.TRAIN_WINDOW),
                           ("small-ingp", cs.OCC_TRAIN_WINDOW),
                           ("small-npngp", cs.OCC_TRAIN_WINDOW),
                           ("small-npngpc", cs.OCC_TRAIN_WINDOW)):
        assert (main_path[f"train {method}"]["scatter_add_rows"]
                >= 1 + 11 + window)
        assert main_path[f"render {method}"]["scatter_add_rows"] == 0
    # the occupancy methods: the grid state's occupied share, the rays whose
    # samples differ between card and CPU (none between CPU and CPU), the
    # grid's update on both sides, and the grid moving over the window
    for method in methods[3:]:
        assert any(line.startswith(f"occupancy {method}: one all-cells update")
                   for line in lines)
        assert any(line.startswith(f"cpu check {method} (4096 rays): rays "
                                   f"whose samples differ (valid mask or "
                                   f"probes) 0 of 4096") for line in lines)
        assert any(line.startswith(f"train cpu check {method}, seed 2: rays "
                                   f"whose samples differ") and " 0 of 64 " in line
                   and "in L2 0.000e+00" in line for line in lines)
        assert any(line.startswith(f"train {method}: grid after the window")
                   for line in lines)
    # per method's train phase: step 0, the split step and the 2 profiled
    # steps, and every one of its 11 + window counted steps; per seed of the
    # CPU checks, each step (K-Planes and the decomposition field's
    # methods: 4 with their witnesses, else 2)
    # (the classic methods and NeuS: 4 more train phases, their CPU checks
    # with the witnesses; semantic-nerfw one more, its check without them)
    assert checks.count("train_phase") == 13 * 4
    assert checks.count("run") == (10 * (11 + cs.TRAIN_WINDOW)
                                   + 3 * (11 + cs.OCC_TRAIN_WINDOW))
    assert checks.count("train_cpu_check") == (
        4 * len(cs.TRAIN_CPU_SEEDS) + 2 * len(cs.NERFACTO_CPU_SEEDS)
        + 4 * len(cs.DEPTH_CPU_SEEDS) + 2 * len(cs.SEMANTIC_CPU_SEEDS)
        + (2 + 4) * len(cs.NERFPLAYER_CPU_SEEDS)
        + (2 + 2 + 4) * len(cs.OCC_CPU_SEEDS)
        + 3 * 4 * len(cs.CLASSIC_CPU_SEEDS) + 4 * len(cs.NEUS_CPU_SEEDS))
    # the deformation MLP's leaves, with the one-ulp witness beside them
    for method in ("small-np", "small-npngpc"):
        line = next(line for line in lines if line.startswith(
            f"train cpu check {method}, seed 2: deformation MLP leaves"))
        assert "cpu vs cpu, directions + 1 ulp" in line
    # the NeRFPlayer methods' rendered component probabilities are held
    # between card and CPU beside rgb
    for method in ("small-np", "small-npngpc"):
        line = next(line for line in lines
                    if line.startswith(f"cpu check {method} (4096 rays): max"))
        assert "'probs'" in line
    # the Trainer phases: K-Planes through Trainer.train on the dynamic data
    # path (IST refreshes, IST rays, checkpoints, a bit-equal resume),
    # instant-ngp-bounded with dynamic_batch, and the convergence gate
    phases = {}
    for line in lines:
        if line.startswith('{"phase"'):
            row = json.loads(line)
            phases.setdefault(row["phase"], []).append(row)
    setup, run = phases["trainer_kplanes"]
    assert setup["overrides"]["iters_to_start_is"] == 2
    assert run["steps"] == 8 and run["final_checkpoint"] == 11
    assert run["resumed_from"] == 8
    assert set(run["split_ms_per_step"]) == {"sampler", "device_batch",
                                             "train_step"}
    assert run["loop_rays_per_s"] > 0 and run["load_ms"] > 0
    assert len(run["refresh_ist_ms"]) >= 2 and len(run["save_ms"]) == 2
    assert int(0.15 * 256) in run["ist_rays_per_batch"]
    # the four train kernels, and the fused one in the eval images
    assert all(run["launches"][k.__name__] > 0 for k in pk.KERNELS)
    assert any(line.startswith("trainer_kplanes small: resumed at step 8 ")
               and "bit-equal" in line for line in lines)
    (ingp,) = phases["trainer_ingp_bounded"]
    assert ingp["steps"] == 6 and ingp["launches"]["scatter_add_rows"] >= 6
    (conv,) = phases["convergence_kplanes_static"]
    assert conv["steps"] == 3 and conv["lpips"] is None
    assert 0 < conv["ssim"] < 1 and np.isfinite(conv["psnr"])
    for path in ("trainer small", "trainer small resumed", "trainer small-ingp",
                 "convergence small-static"):
        assert sum(main_path[path].values()) > 0, path
    # the Trainer reads a step's values on the host (logs, eval batches,
    # dynamic_batch) and saves checkpoints only after the range check:
    # 2 + 2 + 2 checkpoints of the K-Planes runs (the depth run's 6 steps
    # save at step 4 and at the end), one each of the others (the CLI
    # phases' training among them, and TensoRF's, k-planes on
    # HyperNeRF data's, instant-ngp-bounded's and dnerf's through the CLI,
    # semantic-nerfw's through Trainer.train and neus' through the CLI)
    assert checks.count("save_checkpoint") == 16
    assert checks.count("_read") >= 4 + 2 + ingp["steps"]
    # the CLI phase: snt-train from a command line, snt-eval with
    # DynMetric's boxes, the viewer's /render requests, snt-render's three
    # trajectories; each path launched its plane kernels
    # depth supervision: depth-nerfacto's method phases (its batches carry
    # target depths; 3 scatter launches per update step, 1 otherwise; TF32
    # on before the K-Planes CPU check), k-planes through Trainer.train on
    # the fixture's depth maps, depth-nerfacto through the entry points
    # with its live viewer
    assert any(line.startswith("render small-depth: steady") for line in lines)
    assert any(line.startswith("train small-depth: window steps") for line in lines)
    for kind, n in (("update", 3), ("non-update", 1)):
        assert any(line.startswith(f"in-step scatter_add_rows ({kind} step) "
                                   f"small-depth:") and f"in {n} launches" in line
                   and "of bound" in line for line in lines)
    assert any(line.startswith("train cpu check small-depth, seed 2 ")
               and "directions + 1 ulp" in line for line in lines)
    assert any(line.startswith("train cpu check small: TF32 on before the steps")
               for line in lines)
    assert main_path["train small-depth"]["scatter_add_rows"] >= 1 + 11 + cs.TRAIN_WINDOW
    (depth_run,) = phases["trainer_kplanes_depth"]
    assert depth_run["steps"] == 6 and sorted(depth_run["depth_loss"]) == ["0", "2", "4"]
    assert all(v > 0 for v in depth_run["depth_loss"].values())
    assert depth_run["loop_rays_per_s"] > 0
    assert depth_run["trainer_kplanes_loop_rays_per_s"] == run["loop_rays_per_s"]
    assert len(depth_run["refresh_decode_ms_with_depth"]) >= 2
    assert all(depth_run["launches"][k.__name__] > 0 for k in pk.KERNELS)
    (cli_depth,) = phases["cli_depth_nerfacto"]
    argv = cli_depth["train_argv"]
    assert argv[0] == "small-depth" and "nerfstudio-data" in argv
    assert argv[argv.index("--viewer.websocket-port") + 1] == "0"
    assert list(cli_depth["depth_loss"]) == ["0"]
    assert len(cli_depth["live_viewer_render_ms"]["24x16"]) == 2
    assert all(np.isfinite(cli_depth["eval"][k]) for k in ("psnr", "ssim"))
    assert cli_depth["render_frames"] == 3 and cli_depth["render_s_per_frame"] > 0
    # steps 0-3 all update the proposals (the first non-update step is 10)
    assert cli_depth["launches"]["cli train"]["scatter_add_rows"] == 3 * 4
    (cli,) = phases["cli_kplanes"]
    argv = cli["train_argv"]
    assert argv[0] == "small" and argv[argv.index("--max-num-iterations") + 1] == "4"
    assert argv[argv.index("--pipeline.datamanager.iters-to-start-is") + 1] == "2"
    assert cli["train_steps"] == 4 and cli["train_loop_rays_per_s"] > 0
    assert all(np.isfinite(cli["eval"][k]) for k in ("psnr", "ssim", "dpsnr",
                                                      "dssim"))
    assert cli["eval"]["lpips"] is None and cli["eval"]["fps"] > 0
    assert cli["render_frames"] == {"spiral": 3, "interpolate": 3, "filename": 5}
    assert all(v > 0 for v in cli["render_s_per_frame"].values())
    assert list(cli["viewer_first_render_ms"]) == ["24x16 rgb"]
    assert {k: len(v) for k, v in cli["viewer_render_ms"].items()} == {
        "24x16": 1, "40x24": 2}
    assert len(cli["eval_setup_ms"]) == 5
    # the renders through the fused kernel, none through a per-plane
    # forward kernel
    forward = ("bilerp_fwd_unpacked", "bilerp_fwd_packed")
    for path, names in (("cli train small", [k.__name__ for k in pk.TRAIN_KERNELS]),
                        ("cli eval small", ["kplanes_fwd_fused"]),
                        ("viewer small", ["kplanes_fwd_fused"]),
                        ("cli render small", ["kplanes_fwd_fused"])):
        assert all(main_path[path][n] > 0 for n in names), path
    for path in ("render small", "cli eval small", "viewer small",
                 "cli render small"):
        assert main_path[path]["kplanes_fwd_fused"] > 0, path
        assert all(main_path[path][n] == 0 for n in forward), path
    assert all(main_path["train small"][k.__name__] > 0 for k in pk.TRAIN_KERNELS)
    assert main_path["train small"]["kplanes_fwd_fused"] == 0
    # the classic methods: render (TensoRF two counted frames and one
    # profiled, the NeRF methods one), a chunk and a step held against the
    # CPU, the step's leaves with the card's bins beside their witness
    for method, n_frames in (("small-tensorf", 2), ("small-vnerf", 1),
                             ("small-mip", 1)):
        assert any(line.startswith(f"render {method}: {n_frames} frames")
                   for line in lines), method
        assert any(line.startswith(f"render {method}: steady") for line in lines)
        assert any(line.startswith(f"cpu check {method} (") for line in lines)
        assert any(line.startswith(f"train {method}: window steps")
                   for line in lines)
        assert any(line.startswith(f"train cpu check {method}, seed 2: leaves "
                                   f"held with the card's bins") for line in lines)
        assert sum(main_path[f"train {method}"].values()) == 0
    assert any(line.startswith("render small-tensorf: launches per frame")
               for line in lines)
    assert not any(line.startswith("render small-vnerf: launches per frame")
                   for line in lines)
    # TensoRF through Trainer.train: the tables grow at each compressed
    # upsampling step, every optimizer state restarts there, the snapshot
    # reloads at the final resolution
    (tensorf,) = phases["trainer_tensorf"]
    assert [u["step"] for u in tensorf["upsamples"]] == [2, 4]
    assert [u["resolution"] for u in tensorf["upsamples"]] == [20, 24]
    assert all(set(u["counts_after"].values()) == {0} and u["moments_zero"]
               and u["ms"] > 0 for u in tensorf["upsamples"])
    assert tensorf["upsamples"][0]["counts_before"] == {"encodings": 2,
                                                        "fields": 2}
    assert np.isfinite(tensorf["eval_image_psnr"])
    # k-planes, unbounded, on HyperNeRF data: all four plane kernels
    (hyper,) = phases["trainer_kplanes_hypernerf"]
    assert hyper["bounded"] is False and hyper["steps"] == 4
    assert hyper["train_images"] == 4 and hyper["distortion_max"] > 0
    assert all(hyper["launches"]["trainer"][k.__name__] > 0
               for k in pk.TRAIN_KERNELS)
    assert hyper["launches"]["eval image"]["kplanes_fwd_fused"] > 0
    assert all(hyper["launches"]["eval image"][k] == 0 for k in forward)
    # instant-ngp-bounded through the entry points: the live viewer mid-run,
    # the snapshot's grid and render equal to the trainer's, eval, render,
    # the viewer on the snapshot; scatter_add_rows on every step
    (cli_ingp,) = phases["cli_ingp_bounded"]
    argv = cli_ingp["train_argv"]
    assert argv[0] == "small-ingp"
    assert argv[argv.index("--viewer.websocket-port") + 1] == "0"
    assert len(cli_ingp["live_viewer_render_ms"]["24x16"]) == 1
    assert cli_ingp["snapshot_equals_trainer_render"] is True
    assert {k: len(v) for k, v in cli_ingp["viewer_render_ms"].items()} == {
        "24x16": 2, "40x24": 2}
    assert cli_ingp["render_frames"] == 3
    assert all(np.isfinite(cli_ingp["eval"][k]) for k in ("psnr", "ssim"))
    assert cli_ingp["launches"]["cli train"]["scatter_add_rows"] >= 4
    assert main_path["cli train small-ingp"]["scatter_add_rows"] >= 4
    # dnerf on a D-NeRF layout through the entry points
    (cli_dnerf,) = phases["cli_dnerf"]
    assert cli_dnerf["train_argv"][0] == "small-dnerf"
    assert "dnerf-data" in cli_dnerf["train_argv"]
    assert cli_dnerf["render_frames"] == 2 and list(cli_dnerf["losses"]) == ["0"]
    assert all(np.isfinite(cli_dnerf["eval"][k]) for k in ("psnr", "ssim"))
    # semantic-nerfw: render with the CPU check of its composited logits,
    # train on batches with labels (3 scatter launches per update step, 1
    # otherwise), the CPU check of a step; Trainer.train over a Sitcoms3D
    # capture it writes, then snt-eval
    assert any(line.startswith("render small-semantic: steady") for line in lines)
    assert any(line.startswith("cpu check small-semantic (4096 rays): max")
               and "'semantics'" in line for line in lines)
    assert any(line.startswith("train small-semantic: window steps") for line in lines)
    assert any(line.startswith("train cpu check small-semantic, seed 2 ")
               for line in lines)
    assert main_path["train small-semantic"]["scatter_add_rows"] >= 1 + 11 + cs.TRAIN_WINDOW
    (sem,) = phases["trainer_semantic_nerfw"]
    assert sem["steps"] == 4 and sorted(sem["semantics_loss"]) == ["0", "2"]
    assert all(v > 0 for v in sem["semantics_loss"].values())
    assert np.isfinite(sem["eval_batch_semantics_loss"])
    assert sem["launches"]["trainer"]["scatter_add_rows"] == 3 * 4
    assert all(np.isfinite(sem["eval"][k]) for k in ("psnr", "ssim"))
    # neus: one counted frame and a chunk held with its normals, train, the
    # CPU check of a step with the card's bins and the witnesses; the CLI
    assert any(line.startswith("render small-neus: 1 frames") for line in lines)
    assert any(line.startswith("cpu check small-neus (32 rays): max")
               and "'normals'" in line for line in lines)
    assert any(line.startswith("train small-neus: window steps") for line in lines)
    assert any(line.startswith("train cpu check small-neus, seed 2: leaves held "
                               "with the card's bins") for line in lines)
    assert sum(main_path["train small-neus"].values()) == 0
    (cli_neus,) = phases["cli_neus"]
    assert cli_neus["train_argv"][0] == "small-neus"
    assert "nerfstudio-data" in cli_neus["train_argv"]
    assert list(cli_neus["eikonal_loss"]) == ["0"] and cli_neus["render_frames"] == 2
    assert all(np.isfinite(cli_neus["eval"][k]) for k in ("psnr", "ssim"))
    # the exporter's five subcommands on cli_kplanes' snapshot, each with
    # its forward plane kernels counted (cameras renders nothing)
    (export,) = phases["cli_export"]
    subs = export["subcommands"]
    assert list(subs) == ["pointcloud", "cameras", "marching-cubes", "tsdf",
                          "poisson", "marching-cubes at the median"]
    assert subs["marching-cubes at the median"]["elements"]["face"] > 0
    assert all(r["bytes"] > 0 and r["s"] > 0 for r in subs.values())
    assert subs["pointcloud"]["elements"]["vertex"] > 0
    assert subs["poisson"]["elements"]["face"] > 0
    assert set(subs["cameras"]["elements"]) == {"train", "eval"}
    for cmd in ("pointcloud", "marching-cubes", "tsdf", "poisson",
                "marching-cubes at the median"):
        assert main_path[f"cli export {cmd} small"]["kplanes_fwd_fused"] > 0
    assert all(main_path[f"cli export {cmd} small"][f] == 0
               for cmd in subs for f in forward)
    # the fused kernel on the frame's own launches: chunk 0's of each field
    # scale and of proposal_0, bit-equal to the plain version, beside the
    # route it replaced and the library's; the profiled frame's fused time
    # against its bound
    fused = [json.loads(line.split(" ", 2)[2]) for line in lines
             if line.startswith("kernel fused ")]
    assert sorted(r["case"].split(",")[0] for r in fused) == [
        "field scale 0", "field scale 1", "proposal0 scale 0"]
    assert all(r["max_abs_err"] == 0.0 and r["order"] == "frame"
               and r["old_route_ms"] > 0 and r["library_ms"] > 0
               and r["bound_by"] == "bytes" for r in fused)
    # the finest field scale's 256x256 space planes stage unpacked, the
    # rest quad-packed: one launch of both layouts
    finest = next(r for r in fused if r["case"].startswith("field scale 1"))
    assert "'unpacked'" in finest["case"] and "'packed'" in finest["case"]
    assert kernels[4]["name"] == "kplanes_fwd_fused"
    assert kernels[4]["ms"] == pytest.approx(sum(r["ms"] for r in fused))
    assert any(line.startswith("in-frame kplanes_fwd_fused:") and "of bound" in line
               for line in lines)
    k = kernels[5]
    assert k["name"] == "scatter_add_rows"
    assert k["ms"] == pytest.approx(sum(r["ms"] for r in random))
    assert k["bound_ms"] == pytest.approx(
        sum(r["bytes"] for r in random) / cs.H100_BYTES_PER_S * 1e3)


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """Without CUDA it exits non-zero and prints no result, from the
    repository and alone in a directory."""
    if torch.cuda.is_available():
        pytest.skip("needs a machine without CUDA")
    for where in (REPO, tmp_path):
        if where == tmp_path:
            shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
        proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=where,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
