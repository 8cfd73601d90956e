"""The traced window: ``torch.profiler`` over a few steps, frames or
requests of a cell, its chrome trace read back, and what the per-layer
readers take from it.

The window is the benchmark's own ``nerfbench.window`` span, which opens
after a synchronise and closes after the last unit's synchronise.  Device
time is the union of the intervals of every kernel, copy and set in it.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

WINDOW_SPAN = "nerfbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")


@dataclass
class Window:
    """What one run's readers read: the traced window's device and host
    events (microseconds in the trace's clock), the units it held, the
    work those units need (bytes and operations, computed by the
    benchmark), and, of the measured window, untraced, its host-clock
    spans and its seconds a unit (``unit_seconds``).

    Shares of the time a unit takes (idle, MFU) divide by the measured
    window's seconds a unit, not by the traced window's: the profiler
    costs the host some 10 us a launch, so a host-bound unit takes longer
    traced, and that cost would read as device idle time.  The device's
    own busy time a unit is the same in both windows."""

    start: float = 0.0
    end: float = 0.0
    kernels: List[Tuple[str, float, float]] = field(default_factory=list)
    device_ops: List[Tuple[str, float, float]] = field(default_factory=list)
    host_ops: Dict[int, List[Tuple[str, float, float]]] = field(default_factory=dict)
    units: int = 0
    work: Dict[str, float] = field(default_factory=dict)
    spans_ms: Dict[str, List[float]] = field(default_factory=dict)
    unit_seconds: float = 0.0

    @property
    def seconds(self) -> float:
        return (self.end - self.start) / 1e6

    def kernel_seconds(self, match: Callable[[str], bool]) -> float:
        return sum(e - s for n, s, e in self.kernels if match(n)) / 1e6

    def busy_seconds(self) -> float:
        return union_length([(s, e) for _n, s, e in self.device_ops]) / 1e6

    def idle_share(self) -> Optional[float]:
        """1 - the device's busy seconds a traced unit over the measured
        window's seconds a unit."""
        if self.unit_seconds <= 0 or self.units <= 0 or not self.device_ops:
            return None
        return 1.0 - self.busy_seconds() / self.units / self.unit_seconds

    def rate(self, amount: Optional[float]) -> Optional[float]:
        """``amount`` of the traced units (work they need) a second of the
        measured window."""
        if not amount or self.unit_seconds <= 0 or self.units <= 0:
            return None
        return amount / self.units / self.unit_seconds


def union_length(intervals) -> float:
    """Length of the union of [start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def merged(intervals) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def window_bounds(events: list) -> Tuple[float, float]:
    """The traced window in the trace's clock: the benchmark's
    ``nerfbench.window`` span where host operations were traced; else from
    the end of the first to the end of the last device synchronise that
    the runtime recorded (``trace`` brackets the window with them)."""
    for e in events:
        if e.get("ph") == "X" and e.get("name") == WINDOW_SPAN:
            return float(e["ts"]), float(e["ts"]) + float(e["dur"])
    syncs = sorted(float(e["ts"]) + float(e["dur"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") == "cuda_runtime"
                   and "Synchronize" in e.get("name", ""))
    if len(syncs) < 2:
        raise ValueError("the trace holds neither the window span nor the "
                         "synchronises that bracket it")
    return syncs[0], syncs[-1]


def from_chrome_trace(events: list) -> Window:
    """The window of a chrome trace's events (``traceEvents``): device
    operations, and host operations where they were traced, clipped to
    the window (window_bounds)."""
    start, end = window_bounds(events)
    w = Window(start=start, end=end)
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        s = float(e["ts"])
        t = s + float(e["dur"])
        if t <= start or s >= end:
            continue
        s, t = max(s, start), min(t, end)
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            w.device_ops.append((e["name"], s, t))
            if cat == "kernel":
                w.kernels.append((e["name"], s, t))
        elif cat in HOST_CATS and e["name"] != WINDOW_SPAN:
            w.host_ops.setdefault(e.get("tid", 0), []).append((e["name"], s, t))
    return w


def trace(run: Callable[[], int], device, host: bool = False) -> Window:
    """Runs ``run`` (which returns the units it completed) under the
    profiler, synchronised at both ends.  Without ``host`` the profiler
    records the device alone, which costs the host little: the window the
    readers read.  With ``host`` it records the host's operations too,
    and the benchmark's spans, which slows the host several times over:
    that window serves only to say what the host was doing in the device's
    idle gaps.  The chrome trace goes to a directory under $TMPDIR and is
    removed once read."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.device(device).type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (lambda: None)
    sync()
    activities = (([ProfilerActivity.CPU] if host or not cuda else [])
                  + ([ProfilerActivity.CUDA] if cuda else []))
    with profile(activities=activities) as prof:
        sync()
        with record_function(WINDOW_SPAN):
            units = run()
            sync()
    tmp = tempfile.mkdtemp(prefix="nerfbench-trace-")
    try:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    w = from_chrome_trace(events)
    w.units = units
    return w


def host_activity(w: Window, at: List[float]) -> List[str]:
    """For each time in ``at`` (sorted), the innermost host operation
    running then, on any thread ("host: none" where none ran)."""
    best: List[Tuple[float, str]] = [(float("inf"), "host: none")] * len(at)
    for ops in w.host_ops.values():
        ops = sorted(ops, key=lambda o: (o[1], -o[2]))
        stack: List[Tuple[str, float, float]] = []
        j = 0
        for i, t in enumerate(at):
            while j < len(ops) and ops[j][1] <= t:
                while stack and stack[-1][2] <= ops[j][1]:
                    stack.pop()
                stack.append(ops[j])
                j += 1
            while stack and stack[-1][2] <= t:
                stack.pop()
            if stack and stack[-1][2] - stack[-1][1] < best[i][0]:
                best[i] = (stack[-1][2] - stack[-1][1], stack[-1][0])
    return [name for _d, name in best]


def breakdown(device: Window, host: Window, top: int = 10) -> dict:
    """The device operations that took most time in the device-only
    window, and the idle gaps of the host-traced window summed by what the
    host was doing during them (its profiler slows the host, so those
    gaps are longer than the device-only window's)."""
    by_op: Dict[str, float] = {}
    for name, s, e in device.device_ops:
        by_op[name] = by_op.get(name, 0.0) + (e - s) / 1e6
    busy = merged([(s, e) for _n, s, e in host.device_ops])
    edges = [host.start] + [x for iv in busy for x in iv] + [host.end]
    gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    names = host_activity(host, [(a + b) / 2 for a, b in gaps])
    by_host: Dict[str, float] = {}
    for (a, b), name in zip(gaps, names):
        by_host[name] = by_host.get(name, 0.0) + (b - a) / 1e6
    rank = lambda d: [[k[:160], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": rank(by_op), "idle_gaps": rank(by_host)}


class Spans:
    """Host-clock spans the benchmark records around its calls into the
    program in the measured window (no synchronise inside a span)."""

    def __init__(self):
        self.ms: Dict[str, List[float]] = {}

    def timed(self, name: str, fn, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        self.ms.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
        return out


def p95(values) -> float:
    return float(np.percentile(np.asarray(values, dtype=np.float64), 95))
