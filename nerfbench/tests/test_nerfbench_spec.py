"""The benchmark's files: BENCHMARK.json within its contract, every cell's
parts found by name, each configuration file the port's registered
method."""
import dataclasses
import json
import re
from pathlib import Path

import pytest

from nerfbench.harness import spec

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16 and 1 <= len(BENCH["command"]) <= 32
    assert all((ROOT / p).is_dir() and ".." not in p and not p.startswith("/")
               for p in BENCH["paths"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    cells = len(BENCH["workloads"])
    checks = 2 + 14 * 24
    assert checks * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200, cells


def test_names_units_and_text():
    named = (BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"]
             + BENCH["per_layer"])
    for entry in named:
        assert NAME.match(entry["name"]), entry["name"]
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[kind]]
        assert len(names) == len(set(names)), kind
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m
    for text in ([w["why"] for w in BENCH["workloads"]] + [c["why"] for c in BENCH["configs"]]
                 + [c["source"] for c in BENCH["configs"]]
                 + [m["layer"] for m in BENCH["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


@pytest.mark.parametrize("kind,allowed", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
    ("end_to_end", {"name", "unit", "better", "bound", "source", "workloads"}),
    ("per_layer", {"name", "unit", "better", "source", "layer", "moves", "workloads"}),
])
def test_entry_keys(kind, allowed):
    for entry in BENCH[kind]:
        assert set(entry) <= allowed, entry


def test_metrics_and_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span", "program_counter",
                               "host_clock")
        for cell in m.get("workloads", []):
            assert cell in CELLS
            reports = e2e[m["moves"]].get("workloads", CELLS)
            assert cell in reports, (m["name"], cell)
    for cell in CELLS:
        w = spec.workload(cell)
        assert "setup_s" in {m["name"] for m in w["end_to_end"]}
        assert len(w["end_to_end"]) >= 2 and w["per_layer"], cell


@pytest.mark.parametrize("cell", CELLS)
def test_workload_parts_exist(cell):
    w = spec.workload(cell)
    entry = w["entry"]
    assert entry["chips"] in (1, 4)
    assert (spec.BENCH / "traffic" / f"{entry['traffic']}.py").is_file()
    assert (spec.BENCH / "reference" / f"{entry['config']}.py").is_file()
    assert entry["config"] in {c["name"] for c in BENCH["configs"]}
    for m in w["per_layer"]:
        assert hasattr(spec.metric_reader(m["name"]), "read"), m["name"]
    assert w["limits"] and all(v > 0 for v in w["limits"].values())


def test_configs_are_used_and_files_are_theirs():
    used = {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]


def test_kplanes_config_is_the_registered_method():
    from soccernerfs_tpu_torch.configs import method_configs as mc
    from nerfbench.harness import port

    cfg = spec.config("k-planes")
    assert port.model_config(cfg) == mc.model_configs["k-planes"]
    registered = mc.optimizer_configs["k-planes"]
    for group, built in port.optimizer_configs(cfg).items():
        assert built["optimizer"] == registered[group]["optimizer"]
        assert built["scheduler"] == registered[group]["scheduler"]
    assert cfg["train_num_rays_per_batch"] == mc.train_num_rays_per_batch["k-planes"]
    assert cfg["viewer_num_rays_per_chunk"] == \
        mc.trainer_configs["k-planes"].viewer.num_rays_per_chunk
    assert mc.camera_optimizer_configs["k-planes"].mode == cfg["camera_optimizer"]
    assert spec.workload("kplanes-view")["chunk"] == cfg["viewer_num_rays_per_chunk"]
    assert spec.workload("kplanes-train")["rays"] == cfg["train_num_rays_per_batch"]
    assert dataclasses.is_dataclass(port.model_config(cfg))


def test_npnerfacto_config_is_the_registered_method():
    from soccernerfs_tpu_torch.configs import method_configs as mc
    from nerfbench.harness import port

    cfg = spec.config("nerfplayer-nerfacto")
    assert port.model_config(cfg) == mc.model_configs["nerfplayer-nerfacto"]
    registered = mc.optimizer_configs["nerfplayer-nerfacto"]
    for group, built in port.optimizer_configs(cfg).items():
        assert built["optimizer"] == registered[group]["optimizer"]
        assert built["scheduler"] == registered[group]["scheduler"]
    assert cfg["train_num_rays_per_batch"] == \
        mc.train_num_rays_per_batch["nerfplayer-nerfacto"]
    assert mc.camera_optimizer_configs["nerfplayer-nerfacto"].mode == cfg["camera_optimizer"]


@pytest.mark.parametrize("name,count", [("k-planes", 156_050_069),
                                        ("nerfplayer-nerfacto", 401_101_765)])
def test_parameter_counts(name, count):
    import math

    ref = spec.reference(name)
    cfg = spec.config(name)
    specs = ref._param_specs(cfg)
    assert sum(math.prod(shape) for _p, shape, _k in specs) == cfg["parameters"] == count


@pytest.mark.parametrize("name", ["k-planes", "nerfplayer-nerfacto"])
def test_the_harness_weights_have_the_programs_layout(name):
    """Leaf for leaf, the program's tree: its own init at the
    configuration's widths, on the meta device."""
    import torch

    from soccernerfs_tpu_torch.models import get_model
    from nerfbench.harness import compare, port

    cfg = spec.config(name)
    ref = spec.reference(name)
    mine = [("/".join(map(str, p)), tuple(s))
            for p, s, _k in ref._param_specs(cfg)]
    with torch.device("meta"):
        theirs = get_model(cfg["model"]).init(port.model_config(cfg), cfg.get("num_images", 0))
    assert mine == [(p, tuple(t.shape)) for p, t in compare.named_leaves(theirs)]
