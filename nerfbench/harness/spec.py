"""Where the benchmark's parts live, found by the names in BENCHMARK.json.

A cell ``<name>`` is ``workloads/<name>.json``; its configuration is
``configs/<config>.json`` with its plain reference ``reference/<config>.py``;
its traffic kind is ``traffic/<kind>.py``; a per-layer metric ``<metric>``
is read by ``metrics/<metric>.py``, or where there is none by the reader
of its quantity, ``metrics/<quantity>.py``: a metric's quantity is its
name up to the first dot (``idle`` of ``idle.render``), so the splits of
one quantity between cells that move different end-to-end metrics share
a reader.  A cell's end-to-end metric likewise takes the value of its
quantity that the traffic kind measures (``train_rays_per_s`` for
``train_rays_per_s.hash``).  A later change adds a cell, a
configuration, a traffic kind or a metric as new files and entries.
"""
from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def benchmark() -> dict:
    """The repository's BENCHMARK.json."""
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def load_json(rel: str) -> dict:
    return json.loads((BENCH / rel).read_text())


def workload(name: str) -> dict:
    """A cell's file, with its entry of BENCHMARK.json under "entry" and
    the metrics it reports under "end_to_end" and "per_layer"."""
    bench = benchmark()
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = load_json(f"workloads/{name}.json")
    cell["entry"] = entries[name]
    cell["end_to_end"] = [m for m in bench["end_to_end"]
                          if name in m.get("workloads", [name])]
    moved = {m["name"] for m in cell["end_to_end"]}
    cell["per_layer"] = [m for m in bench["per_layer"]
                         if (name in m["workloads"] if "workloads" in m
                             else m["moves"] in moved)]
    return cell


def config(name: str) -> dict:
    return load_json(f"configs/{name}.json")


def _module(kind: str, name: str) -> ModuleType:
    path = BENCH / kind / f"{name}.py"
    key = f"nerfbench_{kind}_{name}".replace("-", "_").replace(".", "_")
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def work(cfg: dict) -> ModuleType:
    """The work counters a configuration's file names (metrics/<work>.py)."""
    return _module("metrics", cfg["work"])


def reference(config_name: str) -> ModuleType:
    return _module("reference", config_name)


def traffic(kind: str) -> ModuleType:
    return _module("traffic", kind)


def quantity(name: str) -> str:
    """A metric's quantity: its name up to the first dot."""
    return name.split(".", 1)[0]


def metric_reader(name: str) -> ModuleType:
    """The reader of per-layer metric ``name``: ``metrics/<name>.py``, else
    ``metrics/<quantity>.py``."""
    if (BENCH / "metrics" / f"{name}.py").exists():
        return _module("metrics", name)
    return _module("metrics", quantity(name))


def read_metrics(names, window) -> Dict[str, float]:
    """Each per-layer metric that its reader finds something to read in
    ``window`` for; a reader that returns None is left out."""
    out = {}
    for name in names:
        value = metric_reader(name).read(window)
        if value is not None:
            out[name] = value
    return out
