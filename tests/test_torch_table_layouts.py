"""The two staged layouts of a K-Planes plane table and the rule that picks
one for each of its users, on the CPU.

A plane [H, W, F] stages as a bf16 table (ops/grid_sample.stage_table):
unpacked [H*W, F], the plane itself, or quad-packed [H*W, 4F], each row
its cell's 2x2 corner block.  The train forward (``_FoldGroup``) stages
every plane unpacked and samples it with ``bilerp_fwd_unpacked``; the
render path (``pack_grids_for_render``, once a snapshot) keeps its rule,
``render_packs``; the narrow F = 8 proposal route stays quad-packed
(``plane_sample_group_bwdsort``).  Both layouts hold the same bf16 values
and the kernels lerp them alike, so a sample is bit-equal in either.  The
card route is driven with each launch replaced by its plain version
(``fake_card``); tests/test_torch_cuda_kernels.py holds the kernels on the
card.
"""
import numpy as np
import pytest
import torch

from soccernerfs_tpu_torch.fields import kplanes as tkpf
from soccernerfs_tpu_torch.ops import grid_sample as tgs
from soccernerfs_tpu_torch.ops.kernels import plane_kernels as pk


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch CPU thread while this file runs (the suite runs in
    parallel worker processes, whose default thread pools oversubscribe
    the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


@pytest.fixture
def fake_card(monkeypatch):
    """The wrappers' card route on CPU tensors, each launch its plain
    version; yields the launches as (kernel, table shape)."""
    launched = []

    def launch(name, ins, rowids, txs, ty, outs, m, feat, *shape):
        launched.append((name, tuple(ins[0].shape)))
        plain = {
            "snt_bilerp_fwd_unpacked": lambda: pk.bilerp_fwd_unpacked_plain(
                ins, rowids, txs, ty, h=shape[0], w=shape[1]),
            "snt_bilerp_fwd_packed": lambda: pk.bilerp_fwd_packed_plain(
                ins, rowids, txs, ty),
            "snt_bilerp_bwd_unpacked": lambda: pk.bilerp_bwd_unpacked_plain(
                ins, rowids, txs, ty, h=shape[0], w=shape[1]),
            "snt_bilerp_bwd_packed": lambda: pk.bilerp_bwd_packed_plain(
                ins, rowids, txs, ty, rows=shape[0]),
        }[name]()
        for o, r in zip(outs, plain):
            o.copy_(r)

    monkeypatch.setattr(pk, "_on_cpu", lambda tensors: False)
    monkeypatch.setattr(pk, "_require_cuda", lambda dev: None)
    monkeypatch.setattr(pk, "_launch", launch)
    yield launched


def _group(rng, h, w, feat, m, n):
    """n planes [h, w, feat] sharing y, and one group's row ids and
    fractions at m points in [-1.1, 1.1] (the borders and past them)."""
    grids = [_t(rng.uniform(0.1, 0.5, (h, w, feat)).astype(np.float32))
             .requires_grad_(True) for _ in range(n)]
    pts = rng.uniform(-1.1, 1.1, (m, n + 1)).astype(np.float32)
    pts[:2] = [[-1.0] * (n + 1), [1.0] * (n + 1)]
    pts = _t(pts)
    yc, ty = pk.grid_coords(pts[:, n], h)
    rowids, txs = [], []
    for c in range(n):
        xc, tx = pk.grid_coords(pts[:, c], w)
        rowids.append(yc * w + xc)
        txs.append(tx)
    return grids, rowids, txs, ty


# ---------------------------------------------------------------------------
# stage_table and the rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("feat", [8, 20, 24, 32, 48])
def test_stage_table_layouts_hold_the_plane(feat):
    """stage_table(plane) is the plane's bf16 values as [H*W, F'] and
    stage_table(plane, True) quad_pack of them, [H*W, 4F'], F' =
    native_feat(F), the padded features 0 in both."""
    rng = np.random.default_rng(feat)
    h, w = 5, 7
    plane = _t(rng.uniform(-1, 1, (h, w, feat)).astype(np.float32))
    wide = pk.native_feat(feat)
    padded = torch.nn.functional.pad(plane, (0, wide - feat)).to(torch.bfloat16)
    unpacked, packed = tgs.stage_table(plane), tgs.stage_table(plane, True)
    assert unpacked.dtype == packed.dtype == torch.bfloat16
    assert unpacked.shape == (h * w, wide) and packed.shape == (h * w, 4 * wide)
    assert torch.equal(unpacked, padded.reshape(h * w, wide))
    assert torch.equal(packed, tgs.quad_pack(padded))
    # a packed row's first quarter is the unpacked row
    assert torch.equal(packed[:, :wide], unpacked)


@pytest.mark.parametrize("h,w,feat,packs", [
    (64, 64, 32, True), (128, 128, 32, True), (100, 512, 32, True),
    (256, 256, 32, False), (1024, 1024, 32, False), (100, 1024, 32, False),
    (100, 1000, 32, True),     # w % 32 != 0
    (256, 256, 24, True), (2048, 2048, 24, True), (100, 2048, 48, True),
    (128, 128, 8, True),
])
def test_render_path_keeps_its_rule(h, w, feat, packs):
    """The render path (staged once a snapshot) quad-packs every plane but
    F = 32 ones of h*w >= 65536 with w % 32 == 0, the JAX package's rule
    (tests/test_torch_plane_kernels.py holds its tables to JAX's)."""
    assert tgs.render_packs(h, w, feat) is packs
    if h * w <= 65536:
        grid = torch.zeros((h, w, feat))
        (table,), = tkpf.pack_grids_for_render({"grids": [[grid]]})["grids_packed"]
        assert table.shape == (h * w, (4 if packs else 1) * feat)


@pytest.mark.parametrize("h,w,feat", [
    (8, 12, 8), (8, 12, 20), (5, 64, 24), (64, 64, 32), (100, 64, 32),
    (256, 256, 32), (6, 16, 48),
])
def test_train_forward_stages_every_plane_unpacked(fake_card, h, w, feat):
    """_FoldGroup stages each plane unpacked at every width and shape (the
    F = 32 planes that the render path quad-packs too) and launches only
    bilerp_fwd_unpacked forward and bilerp_bwd_unpacked backward, over
    [H*W, F'] tables; its samples equal the plain version's."""
    rng = np.random.default_rng([h, w, feat])
    grids, rowids, txs, ty = _group(rng, h, w, feat, 257, 3)
    got = tgs.plane_sample_fold_group(grids, rowids, txs, ty)
    wide = pk.native_feat(feat)
    want = pk.bilerp_fwd_unpacked_plain([tgs.stage_table(g) for g in grids],
                                        rowids, txs, ty, h=h, w=w)
    assert all(torch.equal(g, e[:, :feat]) for g, e in zip(got, want))
    sum(f.sum() for f in got).backward()
    assert fake_card == [("snt_bilerp_fwd_unpacked", (h * w, wide)),
                         ("snt_bilerp_bwd_unpacked", (257, wide))]
    assert all(g.grad is not None and g.grad.shape == g.shape for g in grids)


def test_narrow_proposal_route_stays_packed(fake_card):
    """The F = 8 proposal fields' route (widths divisible by 4) keeps the
    quad-packed tables: bilerp_fwd_packed forward, bilerp_bwd_packed
    backward (its one main path)."""
    rng = np.random.default_rng(8)
    reso = (8, 12, 16, 4)
    grids = [[_t(rng.uniform(0.1, 0.5, (reso[c2], reso[c1], 8))
                 .astype(np.float32)).requires_grad_(True)
              for c1, c2 in tkpf.plane_combinations(4)]]
    pts = _t(rng.uniform(-1, 1, (99, 4)).astype(np.float32))
    out = tkpf.interpolate_kplanes(pts, grids, concat_features=False)
    out.sum().backward()
    kinds = {name for name, _shape in fake_card}
    assert kinds == {"snt_bilerp_fwd_packed", "snt_bilerp_bwd_packed"}
    assert all(shape[1] == 32 for name, shape in fake_card
               if name == "snt_bilerp_fwd_packed")


# ---------------------------------------------------------------------------
# both layouts, one result
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("feat", [8, 20, 24, 32, 48])
def test_both_layouts_sample_bit_equal(feat):
    """The same plane staged both ways: the per-plane forward's plain
    versions (bilerp_fwd_unpacked_plain on [H*W, F'], bilerp_fwd_packed_plain
    on [H*W, 4F']) and the fused kernel's plain version over either
    layout give the same bits, row ids past either end clipped, points on
    and past the borders."""
    rng = np.random.default_rng(30 + feat)
    h, w, m = 9, 13, 401
    grids, rowids, txs, ty = _group(rng, h, w, feat, m, 3)
    rowids[0][5:9] = torch.tensor([-4, -1, h * w, h * w + 7], dtype=torch.int32)
    with torch.no_grad():
        unpacked = [tgs.stage_table(g) for g in grids]
        packed = [tgs.stage_table(g, True) for g in grids]
        a = pk.bilerp_fwd_unpacked_plain(unpacked, rowids, txs, ty, h=h, w=w)
        b = pk.bilerp_fwd_packed_plain(packed, rowids, txs, ty)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
        assert all(x.shape == (m, pk.native_feat(feat)) for x in a)
        pts = _t(rng.uniform(-1.1, 1.1, (m, 4)).astype(np.float32))
        planes = [(0, 3, h, w), (1, 3, h, w), (2, 3, h, w)]
        outs = [pk.kplanes_fwd_fused_plain(pts, tables, planes,
                                           torch.empty((m, feat)))
                for tables in (unpacked, packed, [unpacked[0], packed[1],
                                                  unpacked[2]])]
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])
