"""The data-path runtime: batch image decode and the importance sampler's
inverse-CDF draws (counterpart of soccernerfs_tpu/data/native_loader.py).

The JAX package binds a C++ library here (``native/snt_loader.cpp``): a
thread-pooled libpng/libjpeg decode and ``snt_weighted_sample``.  The port
has no such library:

* ``weighted_samples`` draws from several weight maps at once, draw for
  draw the C++'s.  Its uniforms come from ``uniform_stream``, MT19937-64
  seeded as ``std::mt19937_64(seed)`` and mapped as libstdc++'s
  ``generate_canonical`` maps them, in numpy; its CDFs from
  ``sampler_kernels.cdf_scan_f64`` and its draws from
  ``sampler_kernels.cdf_draw``, which launch their CUDA kernels on CUDA
  tensors and run their plain versions on CPU tensors.  The maps' device
  is the route: the image cache stages them where its dataset computes
  them (CUDA unless the caller names the CPU).
* ``decode_batch`` decodes with Pillow in threads (Pillow lets go of the
  GIL while it decodes) and composites with the C++'s f32 arithmetic.

``available()`` is True: nothing here is optional, a kernel that does not
build or launch raises.  Tests patch it to False to compare the JAX
package's path without its library (numpy's ``choice``, Pillow through the
dataset).
"""
from __future__ import annotations

import concurrent.futures
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np
import torch
from PIL import Image

from soccernerfs_tpu_torch.ops.kernels import sampler_kernels as spk
from soccernerfs_tpu_torch.utils.device import resolve_device


def available() -> bool:
    """Whether the sampler and the image cache take this module's paths:
    always (tests patch it off)."""
    return True


# ---------------------------------------------------------------------------
# the uniform stream: std::mt19937_64 and std::uniform_real_distribution
# ---------------------------------------------------------------------------

_N, _M = 312, 156                                   # state words, shift
_MATRIX_A = np.uint64(0xB5026F5AA96619E9)
_UPPER = np.uint64(0xFFFFFFFF80000000)              # the top 33 bits
_LOWER = np.uint64(0x7FFFFFFF)
_INIT_F = np.uint64(6364136223846793005)
_ONE, _S17, _S29, _S37, _S43, _S62 = (np.uint64(s) for s in (1, 17, 29, 37, 43, 62))
_TEMPER_D = np.uint64(0x5555555555555555)
_TEMPER_B = np.uint64(0x71D67FFFEDA60000)
_TEMPER_C = np.uint64(0xFFF7EEE000000000)
_BELOW_ONE = np.nextafter(1.0, 0.0)


def _seeded(seeds: Sequence[int]) -> np.ndarray:
    """[312, M] states of ``std::mt19937_64(seed)``, one column per seed."""
    mt = np.empty((_N, len(seeds)), np.uint64)
    mt[0] = np.asarray([s & 0xFFFFFFFFFFFFFFFF for s in seeds], np.uint64)
    for i in range(1, _N):
        x = mt[i - 1]
        mt[i] = _INIT_F * (x ^ (x >> _S62)) + np.uint64(i)
    return mt


def _twist(mt: np.ndarray) -> None:
    """One MT19937-64 twist of every column, in place (libstdc++'s
    ``_M_gen_rand``: words 0-155 from the old state, 156-310 from the new
    0-154, 311 from the new 0 and 155)."""
    def mixed(hi, lo, far):
        y = (hi & _UPPER) | (lo & _LOWER)
        return far ^ (y >> _ONE) ^ np.where(y & _ONE, _MATRIX_A, np.uint64(0))

    mt[:_N - _M] = mixed(mt[:_N - _M], mt[1:_N - _M + 1], mt[_M:])
    mt[_N - _M:_N - 1] = mixed(mt[_N - _M:_N - 1], mt[_N - _M + 1:],
                               mt[:_M - 1])
    mt[_N - 1] = mixed(mt[_N - 1], mt[0], mt[_M - 1])


def _tempered(x: np.ndarray) -> np.ndarray:
    x = x ^ ((x >> _S29) & _TEMPER_D)
    x = x ^ ((x << _S17) & _TEMPER_B)
    x = x ^ ((x << _S37) & _TEMPER_C)
    return x ^ (x >> _S43)


def mt19937_64(seeds: Sequence[int], count: int) -> np.ndarray:
    """The first ``count`` outputs of ``std::mt19937_64(seed)`` for each
    seed: uint64 [count, M], vectorised over the seeds."""
    mt = _seeded(seeds)
    words = []
    for _ in range(-(-count // _N)):
        _twist(mt)
        words.append(_tempered(mt))
    return np.concatenate(words)[:count]


def uniform_stream(seeds: Sequence[int], counts: Sequence[int]) -> np.ndarray:
    """The first ``counts[m]`` doubles in [0, 1) of ``seeds[m]``'s stream,
    concatenated in map order: ``std::generate_canonical<double, 53>`` on
    ``std::mt19937_64(seed)``, one 64-bit word a double, ``double(x) *
    2**-64`` (rounded to nearest), 1 mapped to the largest double below
    it.  ``std::uniform_real_distribution(0, total)`` draws ``total`` times
    each."""
    counts = [int(c) for c in counts]
    if not counts:
        return np.zeros(0, np.float64)
    r = mt19937_64(seeds, max(counts)).astype(np.float64) * 2.0 ** -64
    r[r >= 1.0] = _BELOW_ONE
    return np.concatenate([r[:c, m] for m, c in enumerate(counts)])


# ---------------------------------------------------------------------------
# weighted draws
# ---------------------------------------------------------------------------


def weighted_samples(maps: torch.Tensor, ids: Sequence[int],
                     ks: Sequence[int], replaces: Sequence[bool],
                     seeds: Sequence[int]) -> np.ndarray:
    """``ks[m]`` flat indices drawn from map ``ids[m]`` for every m,
    concatenated: ``snt_weighted_sample(maps[ids[m]], ks[m], replaces[m],
    seeds[m])`` of the C++ loader, draw for draw.

    One upload of the uniforms and the draw plan, one scan launch, one draw
    launch and one readback, on the maps' device.

    Args:
        maps: [N, ...] non-negative f16 or f32 weights, each map with a
            positive total; indices are into a map's flattened cells.
    Returns:
        int64 [sum(ks)] numpy.
    """
    maps = maps.reshape(maps.shape[0], -1)
    m = len(ids)
    plan, uni = draw_inputs(ks, replaces, seeds)
    # one host-to-device copy: the plan, the map ids and the uniforms' bits
    packed = torch.from_numpy(np.concatenate(
        [plan.reshape(-1), np.asarray(ids, np.int64), uni.view(np.int64)])
    ).to(maps.device)
    plan_t = packed[:4 * m].view(m, 4)
    ids_t = packed[4 * m:5 * m]
    uni_t = packed[5 * m:].view(torch.float64)
    cdf = spk.cdf_scan_f64(maps, ids_t)
    return spk.cdf_draw(cdf, uni_t, plan_t, int(plan[:, 1].sum())).cpu().numpy()


def draw_inputs(ks: Sequence[int], replaces: Sequence[bool],
                seeds: Sequence[int]):
    """(plan [M, 4] int64, uniforms f64) of ``sampler_kernels.cdf_draw``
    for maps drawn ``ks[m]`` times from ``seeds[m]``'s stream: each map's
    ``draw_count`` uniforms, one after the other."""
    ks = np.asarray(ks, np.int64).reshape(-1)
    counts = [spk.draw_count(int(k), bool(r)) for k, r in zip(ks, replaces)]
    start = lambda n: np.concatenate([[0], np.cumsum(n)[:-1]]).astype(np.int64)
    plan = np.stack([start(counts), ks, np.asarray(replaces, np.int64),
                     start(ks)], axis=1)
    return plan, uniform_stream(seeds, counts)


def weighted_sample(weights: np.ndarray, k: int, replacement: bool, seed: int,
                    device=None) -> Optional[np.ndarray]:
    """k inverse-CDF draws from a flat weight map, on ``device`` (CUDA
    unless named); None when the map's total is not positive, as the C++
    loader returns."""
    w = np.ascontiguousarray(np.asarray(weights).reshape(1, -1), np.float32)
    if k == 0:
        return np.zeros(0, np.int64)
    if w.size == 0 or np.cumsum(w[0], dtype=np.float64)[-1] <= 0:
        return None
    maps = torch.from_numpy(w).to(resolve_device(device))
    return weighted_samples(maps, [0], [k], [replacement], [seed])


# ---------------------------------------------------------------------------
# batch decode
# ---------------------------------------------------------------------------

_INV_255 = np.float32(1.0) / np.float32(255.0)


def _decode(path: Path, height: int, width: int, alpha: np.ndarray
            ) -> Optional[np.ndarray]:
    """One image as the C++ decodes it: JPEG by its extension (any case)
    to RGB, anything else as a PNG to 8-bit RGBA composited over ``alpha``;
    None if it fails or is not ``height`` x ``width``."""
    jpeg = str(path).lower().endswith((".jpg", ".jpeg"))
    try:
        with Image.open(path) as img:
            if img.format not in (("JPEG", "MPO") if jpeg else ("PNG",)):
                return None
            if img.size != (width, height):
                return None
            px = np.asarray(img.convert("RGB" if jpeg else "RGBA"))
    except (OSError, ValueError, SyntaxError):
        return None
    rgb = px[..., :3].astype(np.float32) * _INV_255
    if jpeg:
        return rgb
    a = px[..., 3:].astype(np.float32) * _INV_255
    return rgb * a + alpha * (np.float32(1.0) - a)


def decode_batch(paths: List[Path], height: int, width: int, alpha_color=None,
                 num_threads: int = 8) -> Optional[np.ndarray]:
    """Decode images to float32 [N, H, W, 3] in [0, 1] in ``num_threads``
    threads; None if any image fails (the caller then decodes through the
    dataset).  RGBA composites over ``alpha_color`` (white when None)."""
    alpha = np.asarray(alpha_color if alpha_color is not None
                       else [1.0, 1.0, 1.0], np.float32)
    out = np.zeros((len(paths), height, width, 3), np.float32)

    def one(i):
        image = _decode(paths[i], height, width, alpha)
        if image is None:
            return False
        out[i] = image
        return True

    with concurrent.futures.ThreadPoolExecutor(max(1, num_threads)) as ex:
        ok = list(ex.map(one, range(len(paths))))
    return out if all(ok) else None
