"""chip_smoke.py's control flow, rehearsed on the CPU at a small size.

The script needs a card; here its CUDA calls are stubbed, the kernel
wrappers are made to count their plain versions as launches, and a small
K-Planes config stands in for the full width, so every phase (kernel
check, two counted frames, CPU comparison, the JSON lines) runs in seconds.
Also checks that, without CUDA, the script exits non-zero and prints no
result, both from the repository and alone in a directory.
"""
import dataclasses
import importlib.util
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from soccernerfs_tpu_torch.configs import method_configs as mc
from soccernerfs_tpu_torch.ops.kernels import build
from soccernerfs_tpu_torch.ops.kernels import plane_kernels as pk

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
    monkeypatch.setitem(mc.model_configs, "small", small)
    monkeypatch.setattr(cs, "MODEL", "small")
    monkeypatch.setattr(cs, "DEVICE", "cpu")
    monkeypatch.setattr(cs, "H", 24)
    monkeypatch.setattr(cs, "W", 40)
    monkeypatch.setattr(cs, "card_line", lambda: "stub card, 0 W")
    # a 256 MiB L2 flush per timed call is a card's concern, not a CPU's
    monkeypatch.setattr(cs, "_FLUSH", torch.empty(16, dtype=torch.uint8))
    monkeypatch.setattr(
        cs, "profile_frame",
        lambda render, trace_dir: (render(), {"bilerp_fwd_unpacked": 1.0,
                                              "bilerp_fwd_packed": 1.0})[1])
    for name, value in (("is_available", lambda: True),
                        ("synchronize", lambda *a: None),
                        ("Event", _Event),
                        ("max_memory_allocated", lambda *a: 0),
                        ("get_device_name", lambda *a: "stub"),
                        ("device_count", lambda: 1),
                        ("empty_cache", lambda: None)):
        monkeypatch.setattr(torch.cuda, name, value)
    lib = tmp_path / "libplane_kernels_stub.so"
    lib.with_suffix(".log").write_text("ptxas info    : Used 32 registers\n")
    monkeypatch.setattr(build, "build", lambda name: lib)
    # the wrappers take the "kernel" branch, which runs the plain versions
    monkeypatch.setattr(pk, "_on_cpu", lambda ts: False)
    monkeypatch.setattr(pk, "_check", lambda t, r, x, y, feat:
                        (r[0].shape[0], feat))

    def launch(name, tables, rowids, txs, ty, m, feat, *shape):
        if name == "snt_bilerp_fwd_unpacked":
            return pk.bilerp_fwd_unpacked_plain(tables, rowids, txs, ty,
                                                h=shape[0], w=shape[1])
        return pk.bilerp_fwd_packed_plain(tables, rowids, txs, ty)

    monkeypatch.setattr(pk, "_launch", launch)
    monkeypatch.setattr(sys, "argv", ["chip_smoke.py"])

    assert cs.main() == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == {
        "ok": True, "device": {"platform": "gpu", "kind": "stub", "count": 1}}
    assert lines[-2] == "stub card, 0 W"
    kernels = json.loads(lines[-3])["kernels"]
    assert [k["name"] for k in kernels] == ["bilerp_fwd_unpacked",
                                            "bilerp_fwd_packed"]
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
    for k in kernels:
        assert set(k) == keys
        assert k["launches"] > 0 and k["max_abs_err"] == 0.0
        assert (REPO / k["source"]).is_file()
        assert (REPO / k["replaces"].split(":")[0]).is_file()


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
