"""The K-Planes plane kernels at any feature width: the wrappers' operand
checks and padding, the staged tables, the field and one whole train step
at F = 24 (the paper's resolution study) and at a padded width (F = 20)
against the JAX package on the CPU.

The kernels are compiled for the widths in ``plane_kernels.FEATS``; a
wrapper zero-pads any other width up to 128 to the next of them and drops
the padded output columns.  On the CPU the wrappers run their plain
versions, so the padding route is driven here through the wrappers' card
route with the launch replaced by the plain version at the launched
width (``_fake_card``); tests/test_torch_cuda_kernels.py holds the real
kernels at the same widths on the card.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from soccernerfs_tpu.core import cameras as jcam
from soccernerfs_tpu.fields import kplanes as jkpf
from soccernerfs_tpu.models import kplanes as jk
from soccernerfs_tpu_torch import convert
from soccernerfs_tpu_torch.configs import method_configs as tmc
from soccernerfs_tpu_torch.core import cameras as tcam
from soccernerfs_tpu_torch.engine.trainer import TrainStep
from soccernerfs_tpu_torch.fields import kplanes as tkpf
from soccernerfs_tpu_torch.models import kplanes as tk
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


WIDTHS = (8, 16, 20, 24, 32, 48)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------

def test_native_widths_and_refusal_above_128():
    """Every width from 1 to 128 maps to the least compiled width at or
    above it; the checks refuse only 0 and widths above 128."""
    assert pk.FEATS[-1] == 128 and {8, 16, 24, 32, 48} <= set(pk.FEATS)
    for feat in range(1, 129):
        wide = pk.native_feat(feat)
        assert wide in pk.FEATS and wide >= feat
        assert not [n for n in pk.FEATS if feat <= n < wide]
        pk._check_feat(feat)
    assert pk.native_feat(20) == 24 and pk.native_feat(33) == 48
    for feat in (0, 129, 136, 256):
        with pytest.raises(ValueError, match="feature width must be 1..128"):
            pk._check_feat(feat)


@pytest.fixture
def fake_card(monkeypatch):
    """The wrappers' card route on CPU tensors: the operand checks run
    (all but the device's), and each launch runs the plain version at the
    launched width, which must be a compiled one.  Yields the widths
    launched."""
    widths = []

    def launch(name, ins, rowids, txs, ty, outs, m, feat, *shape):
        assert feat in pk.FEATS, feat
        widths.append(feat)
        kind = name[len("snt_bilerp_"):]
        if kind == "fwd_unpacked":
            res = pk.bilerp_fwd_unpacked_plain(ins, rowids, txs, ty, h=shape[0],
                                               w=shape[1])
        elif kind == "fwd_packed":
            res = pk.bilerp_fwd_packed_plain(ins, rowids, txs, ty)
        elif kind == "bwd_unpacked":
            res = pk.bilerp_bwd_unpacked_plain(ins, rowids, txs, ty, h=shape[0],
                                               w=shape[1])
        else:
            res = pk.bilerp_bwd_packed_plain(ins, rowids, txs, ty, rows=shape[0])
        for o, r in zip(outs, res):
            assert o.shape == r.shape and o.is_contiguous()
            o.copy_(r)

    def launch_fused(pts, tables, planes, out):
        assert out.shape[1] in pk.FEATS
        widths.append(out.shape[1])
        pk.kplanes_fwd_fused_plain(pts, tables, planes, out)

    monkeypatch.setattr(pk, "_on_cpu", lambda tensors: False)
    monkeypatch.setattr(pk, "_require_cuda", lambda dev: None)
    monkeypatch.setattr(pk, "_launch", launch)
    monkeypatch.setattr(pk, "_launch_fused", launch_fused)
    yield widths


def _operands(rng, h, w, m, planes):
    y = rng.uniform(0, h - 1, m).astype(np.float32)
    y[:3] = h - 1
    yc = y.astype(np.int32)
    rowids, txs = [], []
    for _ in range(planes):
        x = rng.uniform(0, w - 1, m).astype(np.float32)
        x[3:6] = w - 1
        xc = x.astype(np.int32)
        rowids.append(_t(yc * w + xc))
        txs.append(_t((x - xc).astype(np.float32)))
    return rowids, txs, _t((y - yc).astype(np.float32))


@pytest.mark.parametrize("feat", WIDTHS)
def test_wrappers_take_every_width(fake_card, feat):
    """The four per-plane wrappers at F (a width outside FEATS padded,
    launched at native_feat(F), the padded columns dropped) equal their
    plain versions at F exactly, and each launch counts once."""
    rng = np.random.default_rng(feat)
    h, w, m, n = 7, 9, 301, 3
    rowids, txs, ty = _operands(rng, h, w, m, n)
    unpacked = [_t(rng.standard_normal((h * w, feat), dtype=np.float32))
                .to(torch.bfloat16) for _ in range(n)]
    packed = [tgs.quad_pack(t.reshape(h, w, feat)).contiguous() for t in unpacked]
    gs = [_t(rng.standard_normal((m, feat), dtype=np.float32)) for _ in range(n)]
    pk.reset_launch_counts()
    pairs = [
        (pk.bilerp_fwd_unpacked(unpacked, rowids, txs, ty, h=h, w=w),
         pk.bilerp_fwd_unpacked_plain(unpacked, rowids, txs, ty, h=h, w=w)),
        (pk.bilerp_fwd_packed(packed, rowids, txs, ty),
         pk.bilerp_fwd_packed_plain(packed, rowids, txs, ty)),
        (pk.bilerp_bwd_unpacked(gs, rowids, txs, ty, h=h, w=w),
         pk.bilerp_bwd_unpacked_plain(gs, rowids, txs, ty, h=h, w=w)),
        (pk.bilerp_bwd_packed(gs, rowids, txs, ty, rows=h * w),
         pk.bilerp_bwd_packed_plain(gs, rowids, txs, ty, rows=h * w)),
    ]
    for got, want in pairs:
        for g, e in zip(got, want):
            assert g.shape == e.shape
            assert torch.equal(g, e)
    assert fake_card == [pk.native_feat(feat)] * 4
    assert [k.launches for k in pk.TRAIN_KERNELS] == [1, 1, 1, 1]
    # counted at the width asked for, before the padding
    assert all(k.launches_by_width == {feat: 1} for k in pk.TRAIN_KERNELS)


@pytest.mark.parametrize("feat", WIDTHS)
def test_fused_wrapper_takes_staged_tables_of_every_width(fake_card, feat):
    """kplanes_fwd_fused at F over the render path's staged tables (padded
    to native_feat(F), both layouts in one launch) writes its scale's
    column slice of the concatenated features and leaves the neighbours
    alone; equal to the CPU route's result."""
    rng = np.random.default_rng(100 + feat)
    reso, m = (256, 256, 6, 5), 333
    grids = [_t(rng.uniform(0.1, 0.5, (reso[c2], reso[c1], feat))
                .astype(np.float32)) for c1, c2 in tkpf.plane_combinations(4)]
    tables = [tgs.stage_table(g, tgs.render_packs(*g.shape)) for g in grids]
    wide = pk.native_feat(feat)
    # the 256x256 XY plane stages unpacked at F = 32 (render_packs' rule)
    assert {t.shape[1] for t in tables} == ({wide, 4 * wide} if feat == 32
                                            else {4 * wide})
    planes = [(c1, c2, reso[c2], reso[c1])
              for c1, c2 in tkpf.plane_combinations(4)]
    pts = _t(rng.uniform(-1.1, 1.1, (m, 4)).astype(np.float32))
    got = torch.full((m, 3 * feat), -7.0)
    pk.reset_launch_counts()
    out = pk.kplanes_fwd_fused(pts, tables, planes, got[:, feat:2 * feat])
    assert out.data_ptr() == got[:, feat:].data_ptr()
    assert pk.kplanes_fwd_fused.launches == 1 and fake_card == [wide]
    assert pk.kplanes_fwd_fused.launches_by_width == {feat: 1}
    # the CPU route: the plain version, at F
    want = pk.kplanes_fwd_fused_plain(pts, tables, planes, torch.empty((m, feat)))
    assert torch.equal(got[:, feat:2 * feat], want)
    assert bool((got[:, :feat] == -7.0).all() and (got[:, 2 * feat:] == -7.0).all())


# ---------------------------------------------------------------------------
# the field against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("feat", [16, 20, 24, 48])
def test_interpolate_kplanes_matches_jax_at_width(feat):
    """Three scales of 4D planes at F concatenated, through the render
    route (staged tables, the fused plain version) and the train route
    (the group samplers, with grad), against JAX's interpolate_kplanes
    (which takes any width through its XLA gather): within 1e-5 of the
    max, the same bf16 table values and f32 lerps."""
    rng = np.random.default_rng(feat)
    reso, mults = (12, 10, 8, 5), (1, 2, 4)
    grids = []
    for mult in mults:
        r = [x * mult for x in reso[:3]] + [reso[3]]
        grids.append([rng.uniform(0.1, 0.5, (r[c2], r[c1], feat)).astype(np.float32)
                      for c1, c2 in tkpf.plane_combinations(4)])
    pts = rng.uniform(-1.1, 1.1, (500, 4)).astype(np.float32)
    pts[:2] = [[-1.0] * 4, [1.0] * 4]
    want = np.asarray(jkpf.interpolate_kplanes(
        jnp.asarray(pts), [[jnp.asarray(g) for g in gs] for gs in grids],
        concat_features=True))
    tgrids = [[_t(g).requires_grad_() for g in gs] for gs in grids]
    staged = tkpf.pack_grids_for_render({"grids": tgrids})["grids_packed"]
    rendered = tkpf.interpolate_kplanes(_t(pts), tgrids, concat_features=True,
                                        ms_packed=staged)
    trained = tkpf.interpolate_kplanes(_t(pts), tgrids, concat_features=True)
    scale = np.abs(want).max()
    for got in (rendered, trained):
        assert got.shape == want.shape == (500, 3 * feat)
        np.testing.assert_allclose(_np(got) / scale, want / scale, atol=1e-5)
    # the train route's gradient reaches every plane at its own width
    trained.sum().backward()
    assert all(g.grad is not None and g.grad.shape == g.shape
               for gs in tgrids for g in gs)


# ---------------------------------------------------------------------------
# one train step against the JAX package
# ---------------------------------------------------------------------------

H = W = 8
N_RAYS = 96
STEP = 300


def _tiny(feat):
    return dict(
        spacetime_resolution=(8, 8, 8, 5), feature_dim=feat, multiscale_res=(1, 2),
        proposal_net_args_list=({"feature_dim": 8, "resolution": (8, 8, 8, 5)},
                                {"feature_dim": 8, "resolution": (16, 16, 16, 5)}),
        num_proposal_samples_per_ray=(24, 16), num_nerf_samples_per_ray=16,
        sigma_net_hidden_dim=32, rgb_net_hidden_dim=32,
        disable_viewing_dependent=True,
        loss_coefficients=dict(tmc._KPLANES_LOSS_COEF))


def _camera_args():
    c2w = np.tile(np.eye(3, 4, dtype=np.float32)[None], (3, 1, 1))
    c2w[:, :, 3] = [[0.2, -0.1, 3.0], [-0.3, 0.2, 2.8], [0.0, 0.1, 3.2]]
    return dict(camera_to_worlds=c2w, fx=7.0, fy=7.5, cx=4.1, cy=3.9,
                width=W, height=H, times=np.array([0.1, 0.5, 0.9], np.float32))


def _unflatten(tree, leaves):
    """A tree shaped like ``tree`` holding ``leaves`` (tree_leaves' order)."""
    it = iter(leaves)

    def walk(x):
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, list):
            return [walk(v) for v in x]
        return next(it)

    return walk(tree)


def _time_noise(tree, rng):
    """Time planes init to exactly 1; jitter them so that their gradients
    and the time losses are not degenerate."""
    if isinstance(tree, dict):
        return {k: _time_noise(v, rng) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_time_noise(v, rng) for v in tree]
    x = np.asarray(tree)
    if x.ndim == 3 and np.all(x == 1.0):
        return (x + rng.uniform(-0.2, 0.2, x.shape)).astype(np.float32)
    return x


@pytest.mark.parametrize("feat", [24, 20])
def test_train_step_matches_jax_at_width(feat):
    """One K-Planes train step at step 300, proposal update on, with the
    main field at F = 24 (kp_res_study's width) or F = 20 (padded to 24 on
    the card): every loss term within 1e-5 relative of jax.value_and_grad's
    and every gradient leaf within 1e-2 of its norm in L2, with the same
    params, batch and draws (JAX's draws handed to the port).  The space
    TV terms are held at 1e-4, the K-Planes step test's bar: both packages
    take the planes' differences in bf16, and XLA's CPU compiler keeps
    them in f32 where torch rounds them (3.0e-5 at F = 24, 6.4e-6 at
    F = 20, 1.2e-6 at F = 32); they read the grids, not the samplers."""
    _step_matches_jax(feat)


def test_train_step_over_unpacked_tables_matches_jax(fake_card):
    """The same step at F = 24 through the wrappers' card route: the
    field's _FoldGroup stages every plane unpacked (stage_table) and
    launches bilerp_fwd_unpacked at F = 24, the F = 8 proposal fields keep
    the quad-packed route (bilerp_fwd_packed and its backward), and the
    step still holds JAX's as above."""
    pk.reset_launch_counts()
    _step_matches_jax(24)
    assert pk.bilerp_fwd_unpacked.launches_by_width == {
        24: pk.bilerp_bwd_unpacked.launches}
    assert set(pk.bilerp_fwd_packed.launches_by_width) == {8}
    assert pk.bilerp_bwd_packed.launches == pk.bilerp_fwd_packed.launches > 0
    assert set(fake_card) == {8, 24}


def _step_matches_jax(feat):
    jcfg = jk.Config(**_tiny(feat))
    tcfg = tk.Config(**_tiny(feat))
    tree = _time_noise(jax.tree_util.tree_map(
        np.asarray, jk.init(jax.random.PRNGKey(0), jcfg)),
        np.random.default_rng(3))
    rng = np.random.default_rng(feat)
    batch = {"cam_idx": rng.integers(0, 3, N_RAYS).astype(np.int32),
             "coords": rng.uniform(0, H, (N_RAYS, 2)).astype(np.float32),
             "image": rng.uniform(0, 1, (N_RAYS, 3)).astype(np.float32)}
    key = jax.random.PRNGKey(11)
    jcams = jcam.Cameras.create(**_camera_args())
    aabb = np.array([[-1.5] * 3, [1.5] * 3], np.float32)

    def loss_fn(p):
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        rays = jcam.generate_rays(jcams, jb["cam_idx"], jb["coords"])
        outputs = jk.get_outputs(jcfg, p, jnp.asarray(aabb), rays, rng=key,
                                 train=True, anneal=jk.proposal_anneal(jcfg, STEP),
                                 train_proposal_networks=True)
        metrics = jk.get_metrics_dict(jcfg, outputs, jb, STEP)
        loss_dict = jk.get_loss_dict(jcfg, p, outputs, jb, metrics, train=True)
        return functools.reduce(jnp.add, loss_dict.values()), loss_dict

    (jloss, jld), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, tree))

    cams = tcam.Cameras.create(**_camera_args(), device="cpu")
    trainer = TrainStep(tcfg, cams, aabb, tmc.optimizer_configs["k-planes"],
                        device="cpu")
    state = trainer.init_state(convert.params_from_jax(tree, device="cpu"))
    state.step = STEP
    rng_sample, rng_bg = jax.random.split(key)
    keys = jax.random.split(rng_sample, tcfg.num_proposal_iterations + 1)
    counts = [*tcfg.num_proposal_samples_per_ray, tcfg.num_nerf_samples_per_ray]
    jitters = [_t(jax.random.uniform(k, (N_RAYS, s + 1)))
               for k, s in zip(keys, counts)]
    loss, ld, _met, grads = trainer.loss_and_grads(
        state, {k: _t(v) for k, v in batch.items()}, train_proposal_networks=True,
        jitters=jitters, background=_t(jax.random.uniform(rng_bg, (N_RAYS, 3))))

    assert set(ld) == set(jld)
    for k in jld:
        want = float(jld[k])
        tol = 1e-4 if k.startswith("space_tv") else 1e-5
        assert abs(float(ld[k]) - want) <= tol * abs(want), (k, float(ld[k]), want)
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    jleaves = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert len(grads) == len(jleaves)
    tgrads = _unflatten(state.params, grads)
    for path, jg in jleaves:
        g = tgrads
        for p in path:
            g = g[p.key if hasattr(p, "key") else p.idx]
        jg = np.asarray(jg)
        assert tuple(g.shape) == jg.shape, path
        err = np.linalg.norm(_np(g) - jg) / max(np.linalg.norm(jg), 1e-30)
        assert err <= 1e-2, (path, err)
    field = state.params["fields"]["grids"]
    assert {g.shape[-1] for gs in field for g in gs} == {feat}
