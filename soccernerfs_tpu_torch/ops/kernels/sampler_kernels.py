"""The importance sampler's inverse-CDF draws: CUDA wrappers, plain
versions and launch counters.

``cdf_scan_f64`` and ``cdf_draw`` (``csrc/sampler_kernels.cu``) replace the
JAX package's C++ sampler ``snt_weighted_sample`` (native/snt_loader.cpp);
there is no TPU kernel.  ``data/native_loader.weighted_samples`` calls
them once each per step for all the maps the step visits.  The source
states the kernels' bound on the card and what their design does about
it.

For CPU tensors a wrapper runs its plain version (the CPU tests' path);
for CUDA tensors it launches its kernel or raises.  Each wrapper's
``launches`` counts kernel launches, and nothing else.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from soccernerfs_tpu_torch.ops.kernels import build

LIBRARIES = ("sampler_kernels",)


def draw_count(k: int, replace: bool) -> int:
    """Uniforms a map's draw of k may consume: k with replacement; else the
    8k + 64 attempts of the rejection walk and k more for its fill."""
    return k if replace else 9 * k + 64


def _check_scan(maps, ids) -> None:
    if maps.dim() != 2 or maps.dtype not in (torch.float16, torch.float32):
        raise ValueError(f"maps must be f16 or f32 [N, S], got {maps.dtype} "
                         f"{list(maps.shape)}")
    if maps.shape[1] < 1:
        raise ValueError("maps must have at least one cell")
    if ids.dim() != 1 or ids.dtype != torch.int64:
        raise ValueError("ids must be int64 [M]")


def _check_draw(cdf, uniforms, plan) -> None:
    if cdf.dim() != 2 or cdf.dtype != torch.float64 or cdf.shape[1] < 1:
        raise ValueError(f"cdf must be f64 [M, S], got {cdf.dtype} "
                         f"{list(cdf.shape)}")
    if uniforms.dim() != 1 or uniforms.dtype != torch.float64:
        raise ValueError("uniforms must be f64 [U]")
    if plan.dtype != torch.int64 or plan.shape != (cdf.shape[0], 4):
        raise ValueError(f"plan must be int64 [{cdf.shape[0]}, 4]")


def _on_cpu(tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _check_cuda(operands) -> None:
    """Operands of a launch: one CUDA device, contiguous, 8-byte aligned."""
    dev = operands[0].device
    for t in operands:
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"kernel operands must share one CUDA device, "
                             f"got {t.device} and {dev}")
        if not t.is_contiguous() or t.data_ptr() % 8:
            raise ValueError("kernel operands must be contiguous and "
                             "8-byte aligned")


def _fn(name, argtypes):
    fn = getattr(build.load(LIBRARIES[0]), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _raise_on(err, name) -> None:
    if err != 0:
        raise RuntimeError(f"{name} failed to launch: CUDA error {err}")


def _launch_scan(maps, ids, out) -> None:
    fn = _fn("snt_cdf_scan_f64", [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p])
    dev = maps.device
    with torch.cuda.device(dev):
        err = fn(maps.data_ptr(), int(maps.dtype == torch.float16),
                 ids.data_ptr(), ids.numel(), maps.shape[1], out.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "snt_cdf_scan_f64")


def _launch_draw(cdf, uniforms, plan, out) -> None:
    fn = _fn("snt_cdf_draw", [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])
    dev = cdf.device
    with torch.cuda.device(dev):
        err = fn(cdf.data_ptr(), cdf.shape[0], cdf.shape[1],
                 uniforms.data_ptr(), plan.data_ptr(), out.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "snt_cdf_draw")


def cdf_scan_f64_plain(maps: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Plain version of cdf_scan_f64: numpy's sequential f64 cumsum of each
    map on the host, the C++ sampler's own sum, bit for bit (a parallel
    scan such as ``torch.cumsum`` on the card adds in another order)."""
    _check_scan(maps, ids)
    rows = maps.index_select(0, ids.to(maps.device)).cpu().numpy()
    return torch.from_numpy(np.cumsum(rows, axis=1, dtype=np.float64))


def walk(lb: np.ndarray, k: int, replace: bool):
    """The C++ sampler's walk over its attempts' indices ``lb``: each one
    kept with replacement; without, an index kept once until k or the
    8k + 64 attempts are spent, then the next ones with replacement.
    Returns (the k indices, how many of ``lb`` it read)."""
    if replace:
        return lb[:k], k
    budget = 8 * k + 64
    kept, seen = [], set()
    attempt = 0
    while len(kept) < k and attempt < budget:
        idx = int(lb[attempt])
        attempt += 1
        if idx not in seen:
            seen.add(idx)
            kept.append(idx)
    fill = lb[attempt:attempt + k - len(kept)]
    return (np.concatenate([np.asarray(kept, np.int64), fill]),
            attempt + fill.size)


def cdf_draw_plain(cdf: torch.Tensor, uniforms: torch.Tensor,
                   plan: torch.Tensor, num_out: int) -> torch.Tensor:
    """Plain version of cdf_draw: ``searchsorted(side="left")`` of each
    map's uniforms times its total (the CDF's last value), clipped to the
    last cell, then the C++'s walk."""
    _check_draw(cdf, uniforms, plan)
    c, u, p = (t.cpu().numpy() for t in (cdf, uniforms, plan))
    out = np.zeros(num_out, np.int64)
    for row, (uni_off, k, replace, out_off) in zip(c, p):
        n = draw_count(int(k), bool(replace))
        lb = np.searchsorted(row, u[uni_off:uni_off + n] * row[-1], side="left")
        lb = np.minimum(lb, row.size - 1)
        out[out_off:out_off + k] = walk(lb, int(k), bool(replace))[0]
    return torch.from_numpy(out)


def cdf_scan_f64(maps: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Inclusive f64 prefix sums of the maps at ``ids``.

    Args:
        maps: [N, S] non-negative f16 or f32 weights.
        ids: [M] int64 rows of ``maps``.
    Returns:
        [M, S] f64, non-decreasing along each row.
    """
    _check_scan(maps, ids)
    if _on_cpu([maps, ids]):
        return cdf_scan_f64_plain(maps, ids)
    _check_cuda([maps, ids])
    out = torch.empty((ids.numel(), maps.shape[1]), dtype=torch.float64,
                      device=maps.device)
    if ids.numel():
        _launch_scan(maps, ids, out)
        cdf_scan_f64.launches += 1
    return out


def cdf_draw(cdf: torch.Tensor, uniforms: torch.Tensor, plan: torch.Tensor,
             num_out: int) -> torch.Tensor:
    """The C++ sampler's draws from each map's CDF.

    Args:
        cdf: [M, S] f64 CDFs, as ``cdf_scan_f64`` gives them.
        uniforms: [U] f64 in [0, 1): map m's ``draw_count`` of them from
            ``plan[m, 0]`` on.
        plan: [M, 4] int64 rows (offset of the map's uniforms, k,
            replacement 0 or 1, offset of its k indices in the output).
        num_out: the output's length, the sum of the k.
    Returns:
        [num_out] int64 flat indices.
    """
    _check_draw(cdf, uniforms, plan)
    if _on_cpu([cdf, uniforms, plan]):
        return cdf_draw_plain(cdf, uniforms, plan, num_out)
    _check_cuda([cdf, uniforms, plan])
    out = torch.empty(num_out, dtype=torch.int64, device=cdf.device)
    if cdf.shape[0]:
        _launch_draw(cdf, uniforms, plan, out)
        cdf_draw.launches += 1
    return out


def empty_launch(device) -> None:
    """One launch of an empty kernel (``csrc/sampler_kernels.cu``) on the
    device's current stream, through the wrappers' ctypes route: the floor
    under a short kernel's time.  No kernel of the port, and uncounted."""
    fn = _fn("snt_sampler_empty_launch", [ctypes.c_void_p])
    dev = torch.device(device)
    with torch.cuda.device(dev):
        err = fn(torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "snt_sampler_empty_launch")


cdf_scan_f64.launches = 0
cdf_draw.launches = 0

KERNELS = (cdf_scan_f64, cdf_draw)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
