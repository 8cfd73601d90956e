"""The port's CUDA plane-sampling kernels against their plain versions, on
the card.

Needs CUDA and nvcc; everywhere else each test skips.  Imports neither JAX
nor the JAX package (the card's machine has neither), so run it without
the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py
"""
import numpy as np
import pytest
import torch

from soccernerfs_tpu_torch.ops.kernels import plane_kernels as pk

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _points(rng, h, w, m, planes, dev, sort=False):
    """Row ids in any order (or sorted by y), x fractions per plane and one
    shared y fraction, with exact right/bottom border cells."""
    y = rng.uniform(0, h - 1, m).astype(np.float32)
    y[3:7] = h - 1
    if sort:
        y.sort()
    yc = y.astype(np.int32)
    rowids, txs = [], []
    for _ in range(planes):
        x = rng.uniform(0, w - 1, m).astype(np.float32)
        x[:5] = w - 1
        xc = x.astype(np.int32)
        rowids.append(torch.from_numpy(yc * w + xc).to(dev))
        txs.append(torch.from_numpy((x - xc).astype(np.float32)).to(dev))
    return rowids, txs, torch.from_numpy((y - yc).astype(np.float32)).to(dev)


CASES = [  # h, w, m, planes, feat
    (25, 16, 700, 2, 32),
    (9, 8, 99, 1, 32),
    (20, 12, 900, 3, 32),
    (100, 16, 555, 3, 32),
    (13, 7, 1001, 3, 8),
    (1, 1, 10, 1, 8),
]


@pytest.mark.parametrize("sort", [False, True])
@pytest.mark.parametrize("h,w,m,planes,feat", CASES)
def test_unpacked_kernel_matches_plain(dev, h, w, m, planes, feat, sort):
    """Each multiply and add rounds as the plain version's ops do, so the
    kernel equals it to 1e-6 relative (bit-equal in practice)."""
    rng = np.random.default_rng(h * 1000 + w)
    tables = [torch.from_numpy(rng.standard_normal((h * w, feat), dtype=np.float32))
              .to(dev, torch.bfloat16) for _ in range(planes)]
    rowids, txs, ty = _points(rng, h, w, m, planes, dev, sort)
    before = pk.bilerp_fwd_unpacked.launches
    got = pk.bilerp_fwd_unpacked(tables, rowids, txs, ty, h=h, w=w)
    want = pk.bilerp_fwd_unpacked_plain(tables, rowids, txs, ty, h=h, w=w)
    torch.cuda.synchronize()
    assert pk.bilerp_fwd_unpacked.launches == before + 1
    for g, e in zip(got, want):
        torch.testing.assert_close(g, e, rtol=1e-6, atol=0)


@pytest.mark.parametrize("sort", [False, True])
@pytest.mark.parametrize("h,w,m,planes,feat", CASES)
def test_packed_kernel_matches_plain(dev, h, w, m, planes, feat, sort):
    rng = np.random.default_rng(h * 1000 + w + 1)
    tables = [torch.from_numpy(rng.standard_normal((h * w, 4 * feat),
                                                   dtype=np.float32))
              .to(dev, torch.bfloat16) for _ in range(planes)]
    rowids, txs, ty = _points(rng, h, w, m, planes, dev, sort)
    before = pk.bilerp_fwd_packed.launches
    got = pk.bilerp_fwd_packed(tables, rowids, txs, ty)
    want = pk.bilerp_fwd_packed_plain(tables, rowids, txs, ty)
    torch.cuda.synchronize()
    assert pk.bilerp_fwd_packed.launches == before + 1
    for g, e in zip(got, want):
        torch.testing.assert_close(g, e, rtol=1e-6, atol=0)


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    table = torch.zeros((12, 32), dtype=torch.bfloat16, device=dev)
    z = torch.zeros(5, dtype=torch.int32, device=dev)
    f = torch.zeros(5, device=dev)
    with pytest.raises(ValueError):      # f32 table
        pk.bilerp_fwd_unpacked([table.float()], [z], [f], f, h=3, w=4)
    with pytest.raises(ValueError):      # wrong row count
        pk.bilerp_fwd_unpacked([table], [z], [f], f, h=4, w=4)
    with pytest.raises(ValueError):      # 4 planes
        pk.bilerp_fwd_unpacked([table] * 4, [z] * 4, [f] * 4, f, h=3, w=4)
    with pytest.raises(ValueError):      # int64 row ids
        pk.bilerp_fwd_unpacked([table], [z.long()], [f], f, h=3, w=4)
    with pytest.raises(ValueError):      # ty of another length
        pk.bilerp_fwd_unpacked([table], [z], [f], f[:4], h=3, w=4)
    with pytest.raises(ValueError):      # mixed devices
        pk.bilerp_fwd_packed([torch.zeros((3, 128), dtype=torch.bfloat16,
                                          device=dev)], [z.cpu()], [f], f)
    with pytest.raises(ValueError):      # F = 16 has no kernel
        pk.bilerp_fwd_packed([torch.zeros((3, 64), dtype=torch.bfloat16,
                                          device=dev)], [z], [f], f)
