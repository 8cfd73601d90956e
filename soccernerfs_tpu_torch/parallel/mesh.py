"""Data parallelism over processes (counterpart of
soccernerfs_tpu/parallel/mesh.py).

The JAX package shards the ray batch over a mesh of every local device and
``pmean``s the gradients inside one program; the port runs one process per
device (the reference's DDP model, ref: scripts/train.py:90-214) and does
the same with ``torch.distributed``:

  * the global ray batch is split by rows (``shard_rows``), rank r taking
    rows [r B/n, (r + 1) B/n);
  * loss, loss dict, metrics and gradients are averaged over the ranks
    (``all_mean``: one all-reduce per dtype bucket, then / n), so the
    params, updated alike on every rank, stay replicated;
  * a whole-image render splits each chunk's rays over the ranks and
    gathers them (``all_gather_rows``);
  * only rank 0 writes (``is_main_process``).

Backends: NCCL on CUDA, gloo on the CPU.  Gloo on CUDA tensors only where a
caller names it (two ranks sharing one card: NCCL refuses two ranks on one
device).  Every process group is made with a timeout, so a rank that died
fails the others instead of hanging them.  ``spawn`` launches the local
ranks; a single-device run that does not ask for ``force_shard_map`` makes
no process group at all.
"""
from __future__ import annotations

import dataclasses
import datetime
import multiprocessing
import os
import queue as queue_module
import tempfile
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

# seconds a collective (and the rendezvous) waits for the other ranks
DEFAULT_TIMEOUT_S = 300.0
# small tensors are reduced packed into flat buffers of at most this size;
# a larger tensor is reduced in place, alone
BUCKET_BYTES = 32 << 20
# elements per chunk of ``tensor_digest``'s integer sums
_DIGEST_CHUNK = 1 << 24


@dataclasses.dataclass(frozen=True)
class World:
    """The ranks a step is sharded over: this process's rank, their count,
    and the process group (None: the default group)."""

    rank: int
    size: int
    group: Any = None


def default_backend(device) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize_distributed(coordinator: Optional[str] = None,
                           num_machines: int = 1, machine_rank: int = 0, *,
                           local_rank: int = 0, local_world_size: int = 1,
                           backend: str = "gloo",
                           init_method: Optional[str] = None,
                           timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join the process group (ref: train.py:124-137's
    ``dist.init_process_group``): rank ``machine_rank * local_world_size +
    local_rank`` of ``num_machines * local_world_size``, meeting at
    ``init_method`` (default ``tcp://<coordinator>``, "host:port" of
    machine 0, whose local rank 0 serves the store).  Blocks until every
    rank has joined, at most ``timeout_s`` seconds, which also bounds every
    later collective."""
    if init_method is None:
        if not coordinator:
            raise ValueError("initialize_distributed needs a coordinator "
                             "(host:port) or an init_method")
        init_method = f"tcp://{coordinator}"
    size = num_machines * local_world_size
    rank = machine_rank * local_world_size + local_rank
    if not (0 <= machine_rank < num_machines and 0 <= local_rank < local_world_size):
        raise ValueError(f"machine_rank {machine_rank} of {num_machines}, "
                         f"local_rank {local_rank} of {local_world_size}")
    dist.init_process_group(backend, init_method=init_method, world_size=size,
                            rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def local_rank() -> int:
    """This process's rank on its machine (``spawn`` sets LOCAL_RANK)."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def is_main_process() -> bool:
    """(ref: utils/comms.py:18-40 is_main_process)."""
    return rank() == 0


def current_world() -> Optional[World]:
    """The default process group's world, or None without one."""
    if not dist.is_initialized():
        return None
    return World(rank=dist.get_rank(), size=dist.get_world_size())


def local_world_size(num_devices: int, device_type: str) -> int:
    """The ranks to run on this machine for ``machine.num_devices``.

    CUDA: -1 is every local device; more than exist takes what exists
    (JAX's ``devices[:num_devices]``) and says so.  The CPU, which a caller
    must ask for: N ranks for N > 0 (as the tests' 8 virtual devices give
    JAX 8), one for -1."""
    if device_type == "cuda":
        count = torch.cuda.device_count()
        if num_devices < 0:
            return count
        if num_devices > count:
            print(f"[parallel] num_devices {num_devices}, but this machine "
                  f"has {count} CUDA devices: world size {count}")
            return count
        return num_devices
    return max(num_devices, 1)


def shard_rows(batch: Dict[str, Any], rank: int, world: int) -> Dict[str, Any]:
    """Rank ``rank``'s rows [r B/n, (r + 1) B/n) of every array of
    ``batch`` (numpy arrays or tensors; the counterpart of ``shard_batch``'s
    addressable shards).  Raises ValueError when n does not divide the
    batch's B rows, as JAX's ``device_put`` does."""
    out = {}
    for k, v in batch.items():
        rows = v.shape[0]
        if rows % world:
            raise ValueError(f"a batch of {rows} rows ({k!r}) does not split "
                             f"over {world} ranks")
        n = rows // world
        out[k] = v[rank * n:(rank + 1) * n]
    return out


def _buckets(tensors: List[torch.Tensor]) -> List[List[int]]:
    """Indices of ``tensors`` grouped for one all-reduce each: per dtype and
    device, consecutive small tensors packed up to ``BUCKET_BYTES``; a
    tensor of that size or more alone."""
    buckets: List[List[int]] = []
    open_: Dict[tuple, tuple] = {}
    for i, t in enumerate(tensors):
        nbytes = t.numel() * t.element_size()
        if nbytes >= BUCKET_BYTES:
            buckets.append([i])
            continue
        key = (t.dtype, t.device)
        b, size = open_.get(key, (None, 0))
        if b is None or size + nbytes > BUCKET_BYTES:
            b, size = [], 0
            buckets.append(b)
        b.append(i)
        open_[key] = (b, size + nbytes)
    return buckets


@torch.no_grad()
def all_mean(tensors: Sequence[Optional[torch.Tensor]], group=None,
             like: Optional[Sequence[torch.Tensor]] = None
             ) -> List[torch.Tensor]:
    """Every tensor averaged over the ranks (JAX's ``pmean``): summed by one
    all-reduce per bucket (``_buckets``), then divided by the world size;
    in order.  The inputs are consumed: a floating tensor of
    ``BUCKET_BYTES`` or more is averaged in place (and returned), the rest
    come back as views of their bucket.  A tensor that is not floating
    point is averaged as f32, as ``pmean`` divides it.

    A None entry is a zero tensor shaped like ``like``'s entry (a
    gradient that a rank's loss did not reach; Adam reads None as zero), so
    every rank reduces the same layout whatever its Nones."""
    n = dist.get_world_size(group)
    out = []
    for i, t in enumerate(tensors):
        if t is None:
            if like is None:
                raise ValueError(f"all_mean: entry {i} is None and no "
                                 f"'like' tensor gives its shape")
            t = torch.zeros_like(like[i])
        elif not t.is_floating_point():
            t = t.float()
        out.append(t.detach().contiguous())
    for bucket in _buckets(out):
        if len(bucket) == 1:
            t = out[bucket[0]]
            dist.all_reduce(t, group=group)
            t.div_(n)
            continue
        flat = torch.cat([out[i].reshape(-1) for i in bucket])
        dist.all_reduce(flat, group=group)
        flat.div_(n)
        offset = 0
        for i in bucket:
            m = out[i].numel()
            out[i] = flat[offset:offset + m].view(out[i].shape)
            offset += m
    return out


@torch.no_grad()
def all_gather_rows(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``t`` concatenated along dim 0, in rank order (the
    gather of a row-sharded array); the ranks' shapes must be equal."""
    n = dist.get_world_size(group)
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts)


@torch.no_grad()
def replicate_tree(tensors: Sequence[torch.Tensor], group=None) -> None:
    """Rank 0's values broadcast into every rank's ``tensors``, in place
    (the params and optimizer state at setup)."""
    for t in tensors:
        dist.broadcast(t.data, src=0, group=group)


_INT_VIEW = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


@torch.no_grad()
def tensor_digest(t: torch.Tensor) -> torch.Tensor:
    """A 2-int64 checksum of ``t``'s bits on its device: the sum of its
    elements' bit patterns, and their sum weighted by position (mod
    65521, + 1); equal tensors give equal digests, and a single changed
    bit changes the first sum."""
    v = t.detach().contiguous().reshape(-1)
    if v.dtype == torch.bool:
        v = v.to(torch.uint8)
    v = v.view(_INT_VIEW[v.element_size()])
    total = torch.zeros(2, dtype=torch.int64, device=v.device)
    for start in range(0, v.numel(), _DIGEST_CHUNK):
        part = v[start:start + _DIGEST_CHUNK].to(torch.int64)
        w = (torch.arange(start, start + part.numel(), device=v.device)
             % 65521) + 1
        total[0] += part.sum()
        total[1] += (part * w).sum()
    return total


def check_replicated(tensors: Sequence[torch.Tensor], group=None) -> np.ndarray:
    """Every rank's ``tensor_digest`` of each of its ``tensors``, gathered
    ([ranks, len(tensors), 2] int64); raises RuntimeError, naming the
    tensors by index, unless every rank holds the same bits in each."""
    with torch.no_grad():
        local = torch.stack([tensor_digest(t) for t in tensors])
        digests = all_gather_rows(local[None], group).cpu().numpy()
    differ = [i for i in range(len(tensors))
              if not (digests[:, i] == digests[0, i]).all()]
    if differ:
        raise RuntimeError(f"the ranks' copies of tensors {differ[:8]}"
                           + (f" and {len(differ) - 8} more" if len(differ) > 8
                              else "") + " differ")
    return digests


def _bind(device: torch.device, local: int) -> torch.device:
    """Make ``device`` this process's (a CUDA device without an index: the
    current one) and note the local rank."""
    os.environ["LOCAL_RANK"] = str(local)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    return device


def _rank_main(local: int, fn: Callable, args: tuple, device: str,
               threads: int, join: dict, results) -> None:
    """A spawned local rank: bind the device (a CPU rank takes ``threads``
    torch threads), join the group, run ``fn(device, *args)``, send back
    ("ok", value) or ("error", traceback)."""
    try:
        dev = _bind(torch.device(device), local)
        if dev.type == "cpu":
            torch.set_num_threads(threads)
        initialize_distributed(local_rank=local, **join)
        try:
            value = fn(dev, *args)
        finally:
            dist.destroy_process_group()
        results.put((local, "ok", value))
    except BaseException:  # reported to rank 0's process, which raises
        results.put((local, "error", traceback.format_exc()))


def spawn(fn: Callable, nprocs: int, args: tuple = (), *,
          devices: Optional[Sequence] = None, backend: Optional[str] = None,
          init_method: Optional[str] = None, coordinator: Optional[str] = None,
          num_machines: int = 1, machine_rank: int = 0,
          timeout_s: float = DEFAULT_TIMEOUT_S) -> List[Any]:
    """Run ``fn(device, *args)`` on this machine's ``nprocs`` ranks, each
    in its own process group rank, and return their values in local-rank
    order.

    Local rank 0 runs in this process (its value is returned as is, so an
    entry point can hand back its Trainer); ranks 1.. are spawned processes
    (``fn``, ``args`` and their values must pickle).  Local rank r runs on
    ``devices[r]``: default ``cuda:r`` when CUDA is available, else the CPU;
    several ranks may share a card under ``backend="gloo"``; a spawned CPU
    rank runs as many torch threads as this process.  ``backend``
    defaults to NCCL on CUDA, gloo on the CPU.  The group meets at
    ``init_method``, default a file in a fresh temporary directory on one
    machine, ``tcp://<coordinator>`` across ``num_machines``.

    Any rank's failure raises here, with the failing rank's traceback:
    ranks still running are terminated, and no join waits longer than
    ``timeout_s``."""
    if devices is None:
        cuda = torch.cuda.is_available()
        devices = [f"cuda:{r}" if cuda else "cpu" for r in range(nprocs)]
    if len(devices) != nprocs:
        raise ValueError(f"{nprocs} ranks, {len(devices)} devices")
    devices = [str(d) for d in devices]
    backend = backend or default_backend(devices[0])
    if num_machines > 1 and not (coordinator or init_method):
        raise ValueError(f"num_machines {num_machines} needs a coordinator "
                         f"(machine 0's host:port)")
    with tempfile.TemporaryDirectory(prefix="snt_parallel_") as tmp:
        if init_method is None and coordinator is None:
            init_method = f"file://{os.path.join(tmp, 'store')}"
        join = dict(coordinator=coordinator, num_machines=num_machines,
                    machine_rank=machine_rank, local_world_size=nprocs,
                    backend=backend, init_method=init_method,
                    timeout_s=timeout_s)
        ctx = multiprocessing.get_context("spawn")
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank_main,
                             args=(r, fn, args, devices[r],
                                   torch.get_num_threads(), join, results),
                             name=f"snt-rank-{r}")
                 for r in range(1, nprocs)]
        for p in procs:
            p.start()
        try:
            dev = _bind(torch.device(devices[0]), 0)
            initialize_distributed(local_rank=0, **join)
            try:
                value = fn(dev, *args)
            finally:
                dist.destroy_process_group()
        except BaseException as e:
            # the spawned ranks' own errors, where they sent one, name the
            # cause this rank saw only as a failed collective
            got = _drain(procs, results, 5.0)
            _stop(procs)
            notes = [f"local rank {r}:\n{v}" for r, (status, v) in sorted(got.items())
                     if status == "error"]
            if notes:
                e.add_note("\n".join(notes))
            raise
        finally:
            os.environ.pop("LOCAL_RANK", None)
        got = _drain(procs, results, timeout_s)
        _stop(procs, timeout_s)
    errors = [f"local rank {r}:\n{v}" for r, (status, v) in sorted(got.items())
              if status == "error"]
    missing = [r for r in range(1, nprocs) if r not in got]
    failed = [(p.name, p.exitcode) for p in procs if p.exitcode != 0]
    if errors or missing or failed:
        raise RuntimeError("spawned ranks failed: " + "\n".join(errors)
                           + (f"\nno result from local ranks {missing}"
                              if missing else "")
                           + (f"\nexit codes {failed}" if failed else ""))
    return [value, *(got[r][1] for r in range(1, nprocs))]


def _drain(procs, results, timeout_s: float) -> Dict[int, tuple]:
    """{local rank: (status, value)} of what the spawned ranks sent, read
    before any join (a rank blocks on exit until its value is read)."""
    got: Dict[int, tuple] = {}
    for _ in procs:
        try:
            local, status, value = results.get(timeout=timeout_s)
        except queue_module.Empty:
            break
        got[local] = (status, value)
    return got


def _stop(procs, timeout_s: float = 0.0) -> None:
    """Join the spawned ranks within ``timeout_s``, then terminate (and
    at last kill) any still running."""
    for p in procs:
        p.join(timeout_s)
    for p in procs:
        if p.is_alive():
            p.terminate()
            p.join(10)
        if p.is_alive():
            p.kill()
            p.join()
