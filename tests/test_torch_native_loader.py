"""The port's data-path runtime (``soccernerfs_tpu_torch/data/
native_loader.py``) against the JAX package's C++ loader, on the CPU.

``weighted_sample`` draw for draw with JAX's ``native_loader.
weighted_sample`` (the port's plain route: numpy's sequential cumsum and
searchsorted over its MT19937-64 stream), the stream against the
standard's check value and the C++'s first draws, ``decode_batch`` within
1.2e-7 of JAX's (the bound ``tests/test_native_loader.py`` holds the C++
to Pillow with), the sampler kernels' card route (its launches stubbed with
the plain versions) as the sampler drives it, and no fallback when a kernel
cannot build.  Skips where JAX's library does not load.
"""
import numpy as np
import pytest
import torch
from PIL import Image

from soccernerfs_tpu.data import native_loader as jnative
from soccernerfs_tpu.data import pixel_samplers as jps
from soccernerfs_tpu_torch.data import native_loader as tnative
from soccernerfs_tpu_torch.data import pixel_samplers as tps
from soccernerfs_tpu_torch.ops.kernels import build
from soccernerfs_tpu_torch.ops.kernels import sampler_kernels as spk

SEEDS = (0, 1, 123456789, 2**62 - 1)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch CPU thread while this file runs (the suite runs in
    parallel worker processes, whose default thread pools oversubscribe
    the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _jax_library():
    if not jnative.available():
        pytest.skip("the JAX package's C++ loader (native/) does not load "
                    "here: no toolchain or image libraries")


def _ist_like(rng, h=540, w=960):
    """An IST map: f16, ~90 % zeros, the rest in (0.15, 1]."""
    m = rng.uniform(0.15, 1.0, (h, w)).astype(np.float16)
    m[rng.random((h, w)) < 0.9] = 0
    return m


def _maps():
    rng = np.random.default_rng(7)
    support3 = np.zeros(257, np.float32)
    support3[[3, 100, 256]] = [0.5, 2.0, 1.0]
    one = np.zeros((24, 32), np.float16)
    one[5, 7] = 0.25
    return {
        "ist": _ist_like(rng),
        "cells257": rng.random(257).astype(np.float32),
        "support3": support3,
        "one_cell": one,
    }


MAPS = _maps()
CASES = [  # map, k, replacement
    ("ist", 20, False), ("ist", 20, True), ("ist", 2, False),
    ("cells257", 7, False), ("cells257", 120, False), ("cells257", 300, True),
    ("support3", 5, False),           # 3 cells at k = 5: the budget runs out
    ("one_cell", 3, False), ("one_cell", 3, True),
]


@pytest.mark.parametrize("name,k,replacement", CASES)
def test_weighted_sample_matches_jax_draw_for_draw(name, k, replacement):
    w = MAPS[name]
    for seed in SEEDS:
        want = jnative.weighted_sample(w.astype(np.float32), k, replacement,
                                       seed)
        got = tnative.weighted_sample(w, k, replacement, seed, device="cpu")
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, want, err_msg=f"seed {seed}")
    if name == "support3":  # the fill repeats kept cells
        assert len(set(got.tolist())) == 3
    if name == "one_cell":
        assert (got == 5 * 32 + 7).all()


@pytest.mark.parametrize("replacement", [False, True])
def test_all_zero_map_returns_none(replacement):
    w = np.zeros((12, 16), np.float16)
    assert jnative.weighted_sample(w.astype(np.float32), 4, replacement, 3) is None
    assert tnative.weighted_sample(w, 4, replacement, 3, device="cpu") is None


def test_several_maps_in_one_call_match_jax():
    """The sampler's call: several maps, their own k, replacement and
    seeds, one scan and one draw for all."""
    rng = np.random.default_rng(3)
    maps = np.stack([_ist_like(rng, 36, 64) for _ in range(5)])
    ids, ks, reps = [4, 0, 2, 3], [20, 20, 7, 2], [False, True, False, False]
    seeds = [int(s) for s in rng.integers(0, 2**62, 4)]
    got = tnative.weighted_samples(torch.from_numpy(maps), ids, ks, reps, seeds)
    want = np.concatenate([
        jnative.weighted_sample(maps[i].astype(np.float32), k, r, s)
        for i, k, r, s in zip(ids, ks, reps, seeds)])
    np.testing.assert_array_equal(got, want)


def test_stream_is_mt19937_64():
    """The standard's check: the 10000th output of a default-seeded
    ``std::mt19937_64`` (seed 5489) is 9981545732273789042."""
    words = tnative.mt19937_64([5489, 5489], 10000)
    assert words.dtype == np.uint64 and words.shape == (10000, 2)
    assert int(words[-1, 0]) == int(words[-1, 1]) == 9981545732273789042


@pytest.mark.parametrize("seed", SEEDS)
def test_stream_gives_the_first_draws_of_jax(seed):
    """On 2**20 cells of weight 1 the CDF is 1, 2, ..., so the C++'s draw
    with replacement is ceil(2**20 * r) - 1: the stream's first 64
    uniforms give JAX's first 64 draws."""
    n = 1 << 20
    want = jnative.weighted_sample(np.ones(n, np.float32), 64, True, seed)
    r = tnative.uniform_stream([seed], [64])
    assert r.dtype == np.float64 and ((r >= 0) & (r < 1)).all()
    np.testing.assert_array_equal(np.maximum(np.ceil(r * n) - 1, 0), want)


def test_plain_scan_is_the_sequential_sum():
    rng = np.random.default_rng(5)
    maps = torch.from_numpy(rng.random((3, 1000)).astype(np.float32) * 1e3)
    ids = torch.tensor([2, 0], dtype=torch.int64)
    cdf = spk.cdf_scan_f64(maps, ids)
    assert cdf.dtype == torch.float64 and cdf.shape == (2, 1000)
    for row, i in zip(cdf.numpy(), (2, 0)):
        acc, want = 0.0, np.empty(1000)
        for j, v in enumerate(maps[i].numpy().astype(np.float64)):
            acc += v
            want[j] = acc
        np.testing.assert_array_equal(row, want)


# ------------------------------------------------------------ batch decode


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    root = tmp_path_factory.mktemp("imgs")
    rng = np.random.default_rng(0)
    files = {}
    rgba = rng.integers(0, 256, (12, 16, 4), np.uint8)
    rgba[0, :4, 3] = [0, 1, 128, 255]
    Image.fromarray(rgba, "RGBA").save(root / "rgba.png")
    files["rgba"] = root / "rgba.png"
    Image.fromarray(rng.integers(0, 256, (12, 16, 3), np.uint8)).save(root / "rgb.png")
    files["rgb"] = root / "rgb.png"
    Image.fromarray(rng.integers(0, 256, (12, 16, 3), np.uint8)).save(
        root / "photo.JPG", quality=95)
    files["jpeg"] = root / "photo.JPG"
    return files


@pytest.mark.parametrize("alpha_color", [None, [0.25, 0.5, 0.75]])
@pytest.mark.parametrize("kinds", [("rgba",), ("rgb",), ("jpeg",),
                                   ("rgba", "rgb", "jpeg", "rgba")])
def test_decode_batch_matches_jax(images, kinds, alpha_color):
    """Within 1.2e-7: the C++ may fuse the composite's multiply and add."""
    paths = [images[k] for k in kinds]
    want = jnative.decode_batch(paths, 12, 16, alpha_color)
    got = tnative.decode_batch(paths, 12, 16, alpha_color, num_threads=3)
    assert got.dtype == np.float32 and got.shape == want.shape == (len(kinds), 12, 16, 3)
    np.testing.assert_allclose(got, want, atol=1.2e-7, rtol=0)


def test_decode_batch_fails_as_jax(images, tmp_path):
    """A missing file and a size that differs give None on both sides.  A
    PNG under a JPEG name gives None here; the C++ is not asked, libjpeg's
    default error handler ends its process."""
    for paths, (h, w) in (([images["rgb"], tmp_path / "missing.png"], (12, 16)),
                          ([images["jpeg"]], (8, 16)), ([images["rgba"]], (12, 8))):
        assert jnative.decode_batch(paths, h, w) is None
        assert tnative.decode_batch(paths, h, w) is None
    (tmp_path / "fake.jpg").write_bytes(images["rgb"].read_bytes())
    assert tnative.decode_batch([tmp_path / "fake.jpg"], 12, 16) is None


# ------------------------------------------ the sampler through the kernels


def _card_route(monkeypatch):
    """The wrappers' kernel branch on CPU tensors, each launch its plain
    version."""
    monkeypatch.setattr(spk, "_on_cpu", lambda ts: False)
    monkeypatch.setattr(spk, "_check_cuda", lambda ts: None)
    monkeypatch.setattr(spk, "_launch_scan", lambda maps, ids, out: out.copy_(
        spk.cdf_scan_f64_plain(maps, ids)))
    monkeypatch.setattr(spk, "_launch_draw", lambda cdf, u, plan, out: out.copy_(
        spk.cdf_draw_plain(cdf, u, plan, out.numel())))


def _ist_batch(steps):
    rng = np.random.default_rng(11)
    maps = np.stack([_ist_like(rng, 24, 40) for _ in range(6)])
    maps[2] = 0                                     # an empty map: skipped
    maps[4] = 0
    maps[4, 3, 5] = 1                               # support 1: replacement
    return {"image_idx": np.arange(6), "iter_steps": steps,
            "image": rng.random((6, 24, 40, 3)).astype(np.float32),
            "ist_weights": torch.from_numpy(maps)}


def test_sampler_launches_both_kernels_per_ist_step(monkeypatch):
    """One scan and one draw launch a step once IST is on, none before, and
    JAX's indices with its library on."""
    _card_route(monkeypatch)
    spk.reset_launch_counts()
    j = jps.DynamicBasedPixelSampler(256, is_pixel_ratio=0.25,
                                     iters_to_start_is=3, seed=4)
    t = tps.DynamicBasedPixelSampler(256, is_pixel_ratio=0.25,
                                     iters_to_start_is=3, seed=4)
    batch = _ist_batch(1)
    jbatch = {**batch, "ist_weights": batch["ist_weights"].numpy()}
    for step in range(1, 7):
        batch["iter_steps"] = jbatch["iter_steps"] = step
        before = [k.launches for k in spk.KERNELS]
        a, b = j.sample(jbatch), t.sample(batch)
        np.testing.assert_array_equal(b["indices"], a["indices"])
        want = 1 if step > 3 else 0
        assert [k.launches - n for k, n in zip(spk.KERNELS, before)] == [want] * 2
    assert (b["indices"][:64, 0] != 2).all()        # floor(0.25 * 256) rays


def test_no_fallback_when_a_kernel_cannot_build(monkeypatch):
    """On the card route a failed build raises out of the sampler: it never
    turns to numpy's choice or to the CPU on its own."""
    monkeypatch.setattr(spk, "_on_cpu", lambda ts: False)
    monkeypatch.setattr(spk, "_check_cuda", lambda ts: None)

    def no_nvcc(name):
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")

    monkeypatch.setattr(build, "load", no_nvcc)
    choice = tps.DynamicBasedPixelSampler._weighted_choice
    monkeypatch.setattr(tps.DynamicBasedPixelSampler, "_weighted_choice",
                        lambda *a: pytest.fail("fell back to numpy's choice"))
    t = tps.DynamicBasedPixelSampler(256, is_pixel_ratio=0.25,
                                     iters_to_start_is=3, seed=4)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        t.sample(_ist_batch(5))
    assert tnative.available() and choice is not None
