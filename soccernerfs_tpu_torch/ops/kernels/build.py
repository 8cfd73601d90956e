"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with its own nvcc for sm_90a into a shared
library with a plain C interface, loaded with ctypes; ``build_all`` starts
one nvcc per source at once.  A library lands in
``soccernerfs_tpu_torch/_build/`` (git-ignored) under a name hashed from
the source and flags, so an edited source rebuilds and a stale library is
never loaded; nvcc's output, with ptxas' register and spill report, is
kept beside it as ``<library>.log``.

Nothing here runs at import: the CPU tests import every module, and nvcc
is only needed once a kernel is launched.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Sequence

PKG = Path(__file__).resolve().parents[2]
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME, $PATH or /usr/local/cuda, in that order."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    which = shutil.which("nvcc")
    if which:
        candidates.append(Path(which))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _library(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD / f"lib{name}_{digest.hexdigest()[:12]}.so"


def build_all(names: Sequence[str]) -> List[Path]:
    """Compile every ``csrc/<name>.cu`` whose library is not current, one
    nvcc process per source, all started together; returns the libraries'
    paths.  Raises with nvcc's output when a build fails."""
    outs = [_library(n) for n in names]
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, out in zip(names, outs):
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        procs.append((name, out, tmp, proc))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {name}.cu:\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is current; returns
    the library's path."""
    return build_all([name])[0]


def load(name: str) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu`` (built at first use)."""
    if name not in _libs:
        _libs[name] = ctypes.CDLL(str(build(name)))
    return _libs[name]
