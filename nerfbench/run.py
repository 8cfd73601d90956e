"""Runs one cell of the benchmark once and prints its result line.

    python3 nerfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration, traffic kind, reference and per-layer
metrics are found by name (BENCHMARK.json, nerfbench/harness/spec.py).
The system under test is the PyTorch and CUDA port,
``soccernerfs_tpu_torch``, on CUDA devices only.  The last line of
standard output is one JSON object (correct, attempted, failed, metrics,
device, with ``--trace 1`` the breakdown, and last the compared numbers
beside their limits); standard error ends with the same compared numbers.
Exits non-zero, with no result, where CUDA or the cell's devices are
missing, or where the JAX package or JAX was loaded.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# modules that no run may load: JAX and the package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "soccernerfs_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN (compared
    whole: ``soccernerfs_tpu_torch`` is not ``soccernerfs_tpu``)."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    os.environ.setdefault("USE_FLAX", "0")
    import torch

    from nerfbench.harness import cell as C
    from nerfbench.harness import spec

    entry = {w["name"]: w for w in spec.benchmark()["workloads"]}.get(args.workload)
    if entry is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"{args.workload} needs {entry['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    # the port's kernel libraries, built in the checkout's _build/ (one
    # nvcc per source, all at once) unless current
    from soccernerfs_tpu_torch.ops.kernels import build

    build.build_all(sorted(p.stem for p in build.CSRC.glob("*.cu")))
    line = C.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), device)

    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}; the benchmark runs the "
              f"port alone", file=sys.stderr)
        return 4
    for name, c in line["checks"].items():
        verdict = "ok" if c["value"] <= c["limit"] else "OVER THE LIMIT"
        print(f"check {name}: {c['value']!r} limit {c['limit']!r} {verdict}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
