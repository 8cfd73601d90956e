"""Function-timing profiler (counterpart of soccernerfs_tpu/utils/profiler.py).

``@time_function`` keeps a running average of host seconds per function
once ``setup_profiler(True)`` ran; ``flush_profiler`` prints them sorted.
A call that only queues work on the card returns before the work is done,
so these are host times.  For the device's kernels, ``torch_trace`` writes
a ``torch.profiler`` chrome trace.
"""
from __future__ import annotations

import contextlib
import functools
import time
from pathlib import Path
from typing import Dict

import torch

_ENABLED = False
_STATS: Dict[str, tuple] = {}


def setup_profiler(enabled: bool) -> None:
    global _ENABLED
    _ENABLED = enabled


def time_function(fn):
    """``fn``, timed into the running averages while the profiler is on."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if not _ENABLED:
            return fn(*args, **kwargs)
        start = time.time()
        out = fn(*args, **kwargs)
        dt = time.time() - start
        name = getattr(fn, "__qualname__", fn.__name__)
        prev_avg, prev_n = _STATS.get(name, (0.0, 0))
        _STATS[name] = ((prev_avg * prev_n + dt) / (prev_n + 1), prev_n + 1)
        return out

    return wrapper


def flush_profiler() -> None:
    """Print the running-average table."""
    if not _ENABLED or not _STATS:
        return
    print("\n[profiler] average call times:")
    for name, (avg, n) in sorted(_STATS.items(), key=lambda kv: -kv[1][0]):
        print(f"  {name:<60s} {avg * 1000:10.2f} ms  (n={n})")


@contextlib.contextmanager
def torch_trace(log_dir):
    """Trace the host and, where there is one, the CUDA device inside the
    block; writes ``trace.json`` (chrome://tracing, Perfetto) to
    ``log_dir``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / "trace.json"))
