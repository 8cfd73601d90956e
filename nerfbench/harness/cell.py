"""One run of one cell: the context a traffic kind gets, and the result
line it makes.

``run_cell`` does what a run does after the harness has found the chips:
it finds the cell's configuration, reference and traffic kind by name,
runs the traffic (set-up, the measured window, with ``trace`` the traced
window, then the comparison with the reference) and returns the result.
The CPU tests call it at a small size, ``overrides`` shrinking the
configuration and the cell, and with ``fault`` naming a way to break the
timed path underneath (harness/faults.py).
"""
from __future__ import annotations

import math
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from nerfbench.harness import spec


def process_seconds() -> float:
    """Seconds since this process started (its start time in /proc), or
    since the harness was imported where /proc has none."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED


_IMPORTED = time.perf_counter()


@dataclass
class Context:
    cell_name: str
    cell: dict
    cfg: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    overrides: Dict[str, object] = field(default_factory=dict)
    fault: Optional[str] = None

    @property
    def reference(self):
        return spec.reference(self.cfg["name"])

    def param(self, key):
        """A cell parameter, or its override in a test."""
        return self.overrides.get(key, self.cell[key])


@dataclass
class Check:
    """One number compared with the reference, beside its limit; a number
    passes when it is finite and at most the limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


def checks_of(readings: Dict[str, float], limits: Dict[str, float]) -> List[Check]:
    return [Check(k, float(readings[k]), float(limits[k])) for k in limits]


def run_cell(name: str, seed: int, seconds: float, trace: bool, device, *,
             overrides: Optional[dict] = None, fault: Optional[str] = None) -> dict:
    ctx = context(name, seed, device, overrides)
    ctx.seconds, ctx.trace, ctx.fault = float(seconds), bool(trace), fault
    return spec.traffic(ctx.cell["entry"]["traffic"]).run(ctx)


def context(name: str, seed: int, device, overrides: Optional[dict] = None) -> Context:
    """The context of a run of cell ``name`` without a window (the probe's
    and the tests')."""
    cell = spec.workload(name)
    cfg = spec.config(cell["entry"]["config"])
    if overrides and "config" in overrides:
        cfg = {**cfg, "config": {**cfg["config"], **overrides["config"]}}
    return Context(cell_name=name, cell=cell, cfg=cfg, seed=int(seed), seconds=0.0,
                   trace=False, device=device,
                   overrides={k: v for k, v in (overrides or {}).items() if k != "config"})


def result_line(ctx: Context, *, attempted: int, failed: int, e2e: Dict[str, tuple],
                checks: List[Check], memory_peak: int, window=None,
                host_window=None, extra: Optional[dict] = None) -> dict:
    """The result's JSON object: ``e2e`` {quantity: (value, unit)} that the
    traffic kind measured, each reported under the cell's end-to-end
    metrics of that quantity (spec.quantity); with a traced ``window`` the cell's
    per-layer metrics instead, ``busy_s``, ``window_s`` and the
    breakdown (with the host-traced ``host_window``'s idle gaps).  The
    compared numbers come last, under "checks"."""
    import torch

    from nerfbench.harness import tracing

    units = {m["name"]: m["unit"] for m in ctx.cell["per_layer"] + ctx.cell["end_to_end"]}
    if ctx.trace:
        values = spec.read_metrics([m["name"] for m in ctx.cell["per_layer"]], window)
        metrics = {k: {"value": v, "unit": units[k]} for k, v in values.items()}
    else:
        metrics = {m["name"]: {"value": e2e[spec.quantity(m["name"])][0], "unit": m["unit"]}
                   for m in ctx.cell["end_to_end"] if spec.quantity(m["name"]) in e2e}
    dev = torch.device(ctx.device)
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
              "count": 1, "memory_peak_bytes": int(memory_peak)}
    if ctx.trace:
        device["busy_s"] = window.busy_seconds()
        device["window_s"] = window.seconds
    line = {"correct": bool(failed == 0 and checks and all(c.ok for c in checks)),
            "attempted": int(attempted), "failed": int(failed),
            "metrics": metrics, "device": device}
    if ctx.trace:
        line["breakdown"] = tracing.breakdown(window, host_window)
    if extra:
        line.update(extra)
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    return line
