"""Plain PyTorch reference of the ``k-planes`` configuration
(nerfbench/configs/k-planes.json): dynamic K-Planes behind two K-Planes
proposal fields, as nerfstudio v0.1.19 (vendored by SoccerNeRFs) defines
it, at the precisions the configuration states.

Imports torch and numpy only.  It reads the configuration's own file and
the inputs the harness hands it (weights made here from the seed, rays,
batches, the draws' generator state); everything the program derives from
them (staged tables, sample points, proposal weights, the optimizer's
state) is worked out again here.

Precision, as the configuration states it: float32 with TF32 off, except
that the plane tables are sampled as bf16-rounded values (their gradient
is taken in f32), each MLP layer rounds its operands to bf16 and
multiplies them in f32, the plane TV regularisers take their differences
in bf16, and Adam stores its first moment in bf16.  ``dtype=bfloat16``
computes everything in bf16 instead: the control, which the comparison
has to refuse.

Parameter layout (the program's, which the harness hands to both sides):
{"fields": {"grids": [scale][plane] [H, W, F], "sigma_net": {"w", "b"},
"color_net": {"w", "b"}}, "proposal_networks": {"proposal_i": {"grids":
[[plane]], "sigma_net": {"w", "b"}}}}; planes in the order XY, XZ, XT,
YZ, YT, ZT, each [res[c2], res[c1], F]; MLP weights [in, out].
"""
from __future__ import annotations

import contextlib
import itertools
import math
from typing import Dict, List, Optional

import numpy as np
import torch

F32 = torch.float32
BF16 = torch.bfloat16
COMBOS = list(itertools.combinations(range(4), 2))   # XY XZ XT YZ YT ZT
SPACE_IDS, TIME_IDS = (0, 1, 3), (2, 4, 5)
GEO_FEAT_DIM = 15
B1, B2 = 0.9, 0.999


@contextlib.contextmanager
def no_tf32():
    """f32 matmuls in f32 (TF32 off) inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

def scale_resolutions(c: dict) -> List[List[int]]:
    res = c["spacetime_resolution"]
    return [[r * m for r in res[:3]] + [res[3]] for m in c["multiscale_res"]]


def mlp_dims(c: dict) -> Dict[str, tuple]:
    """{name: layer widths} of the main field's MLPs."""
    feat = c["feature_dim"] * len(c["multiscale_res"])
    return {
        "sigma_net": [feat] + [c["sigma_net_hidden_dim"]] * c["sigma_net_layers"]
        + [GEO_FEAT_DIM + 1],
        "color_net": [GEO_FEAT_DIM] + [c["rgb_net_hidden_dim"]] * c["rgb_net_layers"]
        + [3],
    }


def _param_specs(cfg: dict):
    """[(path, shape, kind)]: kind ("uniform", a, b), ("ones",) or
    ("mlp", fan_in), in the program's leaf order."""
    c = cfg["config"]
    specs = []

    def planes(prefix, reso, feat, a, b):
        for i, (c1, c2) in enumerate(COMBOS):
            shape = (reso[c2], reso[c1], feat)
            kind = ("ones",) if 3 in (c1, c2) else ("uniform", a, b)
            specs.append((prefix + (i,), shape, kind))

    def mlp(prefix, dims):
        for key in ("w", "b"):
            for i in range(len(dims) - 1):
                shape = (dims[i], dims[i + 1]) if key == "w" else (dims[i + 1],)
                specs.append((prefix + (key, i), shape, ("mlp", dims[i])))

    for s, reso in enumerate(scale_resolutions(c)):
        planes(("fields", "grids", s), reso, c["feature_dim"], 0.1, 0.5)
    for name, dims in mlp_dims(c).items():
        mlp(("fields", name), dims)
    for i, args in enumerate(c["proposal_net_args_list"]):
        prefix = ("proposal_networks", f"proposal_{i}")
        planes(prefix + ("grids", 0), args["resolution"], args["feature_dim"],
               0.1, 0.15)
        mlp(prefix + ("sigma_net",), [args["feature_dim"], 64, 1])
    return specs


def _put(tree, path, value):
    node = tree
    for key, nxt in zip(path[:-1], path[1:]):
        if key not in node if isinstance(node, dict) else key >= len(node):
            child = [] if isinstance(nxt, int) else {}
            if isinstance(node, dict):
                node[key] = child
            else:
                node.append(child)
        node = node[key]
    if isinstance(node, dict):
        node[path[-1]] = value
    else:
        node.append(value)


def make_params(cfg: dict, seed: int, device) -> dict:
    """The configuration's initial weights from ``seed``: space planes
    U(0.1, 0.5) (proposal fields U(0.1, 0.15)), time planes 1, MLP weights
    and biases U(-1/sqrt(fan_in), 1/sqrt(fan_in)); one draw of every
    uniform on the device, in f32."""
    specs = _param_specs(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2**63)
    drawn = [s for s in specs if s[2][0] != "ones"]
    total = sum(math.prod(shape) for _p, shape, _k in drawn)
    u = torch.rand(total, generator=gen, device=device)
    tree: dict = {}
    at = 0
    for path, shape, kind in specs:
        if kind[0] == "ones":
            leaf = torch.ones(shape, device=device)
        else:
            n = math.prod(shape)
            leaf = u[at:at + n].view(shape)
            at += n
            if kind[0] == "uniform":
                leaf.mul_(kind[2] - kind[1]).add_(kind[1])
            else:
                leaf.mul_(2.0).sub_(1.0).mul_(1.0 / math.sqrt(kind[1]))
            leaf = leaf.clone()
        _put(tree, path, leaf)
    del u
    return tree


def leaves(tree, prefix=""):
    """[(path, tensor)] depth first, dicts in insertion order."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in leaves(v, f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in leaves(v, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


# ---------------------------------------------------------------------------
# rays and samples
# ---------------------------------------------------------------------------

def rays(c2w, fx, fy, cx, cy, times, coords):
    """Pinhole rays of pixels ``coords`` [N, 2] (row, col) of cameras whose
    per-ray poses are ``c2w`` [N, 3, 4] (intrinsics [N]): origins [N, 3],
    unit directions [N, 3], times [N]."""
    y, x = coords[:, 0], coords[:, 1]
    d_cam = torch.stack([(x - cx) / fx, -(y - cy) / fy, -torch.ones_like(x)], -1)
    d = torch.einsum("nj,nij->ni", d_cam, c2w[:, :3, :3])
    d = d / torch.clamp(torch.linalg.vector_norm(d, dim=-1, keepdim=True), min=1e-10)
    return c2w[:, :3, 3], d, times


def near_far(origins, directions, aabb):
    inv = 1.0 / (directions + 1e-6)
    t0 = (aabb[0] - origins) * inv
    t1 = (aabb[1] - origins) * inv
    near = torch.clamp(torch.amax(torch.minimum(t0, t1), -1), min=0.0)
    far = torch.maximum(torch.amin(torch.maximum(t0, t1), -1), near + 1e-6)
    return near, far


def uniform_edges(num_samples, jitter, n, dtype, device):
    """Stratified edges in [0, 1], [N, S + 1]: bin centres jittered by
    ``jitter`` (None: the plain edges)."""
    e = torch.linspace(0.0, 1.0, num_samples + 1, device=device, dtype=dtype)[None]
    if jitter is None:
        return e.expand(n, num_samples + 1)
    mid = (e[:, 1:] + e[:, :-1]) / 2.0
    upper = torch.cat([mid, e[:, -1:]], -1)
    lower = torch.cat([e[:, :1], mid], -1)
    return lower + (upper - lower) * jitter.to(dtype)


def pdf_edges(s_edges, weights, num_samples, jitter):
    """Inverse-CDF resampling of [N, S] weights over s-space edges
    [N, S + 1]: ``num_samples`` + 1 new edges (u at bin midpoints without
    a jitter)."""
    nb = num_samples + 1
    w = weights + 0.01
    wsum = w.sum(-1, keepdim=True)
    pad = torch.relu(1e-5 - wsum)
    w = w + pad / w.shape[-1]
    wsum = wsum + pad
    cdf = torch.clamp(torch.cumsum(w / wsum, -1), max=1.0)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], -1)
    u = torch.linspace(0.0, 1.0 - 1.0 / nb, nb, device=w.device, dtype=w.dtype)[None]
    u = u + (jitter.to(w.dtype) / nb if jitter is not None else 1.0 / (2 * nb))
    u = u.expand(cdf.shape[0], nb).contiguous()
    k = cdf.shape[-1]
    idx = torch.searchsorted(cdf.contiguous(), u, right=True)
    lo = torch.clamp(idx - 1, min=0)
    hi = torch.clamp(idx, max=k - 1)
    c0, c1 = cdf.gather(-1, lo), cdf.gather(-1, hi)
    b0, b1 = s_edges.gather(-1, lo), s_edges.gather(-1, hi)
    t = torch.clamp(torch.nan_to_num((u - c0) / (c1 - c0)), 0.0, 1.0)
    return (b0 + t * (b1 - b0)).detach()


def volume_weights(density, deltas):
    dd = deltas * torch.clamp(density, max=torch.finfo(density.dtype).max)
    alpha = 1.0 - torch.exp(-dd)
    shifted = torch.cat([torch.zeros_like(dd[:, :1]), dd[:, :-1]], -1)
    return torch.nan_to_num(alpha * torch.exp(-torch.cumsum(shifted, -1)))


# ---------------------------------------------------------------------------
# fields
# ---------------------------------------------------------------------------

class _TruncExp(torch.autograd.Function):
    """exp, whose derivative is taken at x clamped to [-15, 15] (the
    configuration's density activation)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(torch.clamp(x, -15.0, 15.0))


def bf16_round(t):
    """The value rounded to bf16, kept in t's type; the gradient flows
    through the rounding as it does through a cast."""
    return t.to(BF16).to(t.dtype) if t.dtype != BF16 else t


def table(plane, dtype):
    """The sampled values of a plane: bf16-rounded, gradient straight to
    the f32 plane."""
    if dtype == BF16:
        return plane.to(BF16)
    return plane + (plane.detach().to(BF16).to(F32) - plane.detach())


def sample_plane(plane, x, y):
    """Bilinear sample of an [H, W, F] plane at x (width) and y (height)
    in [-1, 1], align_corners and border clamping: [M, F]."""
    h, w, f = plane.shape

    def axis(c, size):
        v = torch.clamp((c + 1.0) * 0.5 * (size - 1), 0.0, size - 1)
        i0 = torch.floor(v).detach()
        # in bf16 (the control) size - 1 may round up to size
        cell = torch.clamp(i0.long(), 0, size - 1)
        return cell, (v - i0)[:, None], torch.clamp(cell + 1, max=size - 1)

    x0, tx, x1 = axis(x, w)
    y0, ty, y1 = axis(y, h)
    flat = plane.reshape(h * w, f)
    top = flat[y0 * w + x0] * (1.0 - tx) + flat[y0 * w + x1] * tx
    bot = flat[y1 * w + x0] * (1.0 - tx) + flat[y1 * w + x1] * tx
    return top * (1.0 - ty) + bot * ty


def plane_features(scales, pts, concat, dtype):
    """Product over a scale's planes of their samples, concatenated (or
    summed) over the scales: [M, F * scales] (or [M, F])."""
    per_scale = []
    for planes in scales:
        acc = None
        for plane, (c1, c2) in zip(planes, COMBOS):
            f = sample_plane(table(plane, dtype), pts[:, c1], pts[:, c2])
            acc = f if acc is None else acc * f
        per_scale.append(acc)
    if concat:
        return torch.cat(per_scale, -1)
    return sum(per_scale[1:], per_scale[0])


def mlp(params, x, act, out_act, dtype):
    """Each layer: operands rounded to bf16, products and sums in f32 (in
    bf16 throughout with ``dtype`` bf16)."""
    h = x
    n = len(params["w"])
    for i, (w, b) in enumerate(zip(params["w"], params["b"])):
        if dtype == BF16:
            h = h.to(BF16) @ w.to(BF16) + b.to(BF16)
        else:
            h = bf16_round(h) @ bf16_round(w) + b
        a = out_act if i == n - 1 else act
        if a == "relu":
            h = torch.relu(h)
        elif a == "sigmoid":
            h = torch.sigmoid(h)
    return h


def normalized(positions, times, aabb):
    p = (positions - aabb[0]) / (aabb[1] - aabb[0]) * 2.0 - 1.0
    return torch.cat([p, (times * 2.0 - 1.0)[:, None].to(p.dtype)], -1)


def proposal_density(params, pts, dtype):
    feats = plane_features(params["grids"], pts, False, dtype)
    out = mlp(params["sigma_net"], feats, "relu", None, dtype)[:, 0]
    return _TruncExp.apply(out)


def field(params, pts, dtype):
    """(density [M], rgb [M, 3]) of the main field: view-independent."""
    feats = plane_features(params["grids"], pts, True, dtype)
    out = mlp(params["sigma_net"], feats, "relu", None, dtype)
    geo, raw = out[:, :GEO_FEAT_DIM], out[:, -1]
    rgb = mlp(params["color_net"], geo, "relu", "sigmoid", dtype)
    return _TruncExp.apply(raw), rgb


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def proposal_anneal(c: dict, step: int) -> float:
    if not c["use_proposal_weight_anneal"]:
        return 1.0
    f = np.float32
    x = np.clip(f(step) / f(c["proposal_weights_anneal_max_num_iters"]), f(0), f(1))
    b = f(c["proposal_weights_anneal_slope"])
    return float((b * x) / ((b - f(1)) * x + f(1)))


def proposal_updates(c: dict, step: int, since: int, n: int) -> List[bool]:
    """Whether each of ``n`` steps from ``step`` trains the proposal
    networks, ``since`` steps after the last that did: nerfstudio's
    schedule, every step before step 10, then once the count of steps
    since the last update, this one included, passes the interval, which
    grows linearly from 1 to ``proposal_update_every`` over the warm-up."""
    out = []
    for s in range(step, step + n):
        interval = float(np.clip(np.interp(s, [0, c["proposal_warmup"]],
                                           [0, c["proposal_update_every"]]),
                                 1, c["proposal_update_every"]))
        update = since + 1 > interval or s < 10
        since = 0 if update else since + 1
        out.append(update)
    return out


def sample_counts(c: dict) -> List[int]:
    return [*c["num_proposal_samples_per_ray"], c["num_nerf_samples_per_ray"]]


def draws(cfg: dict, n: int, generator, device) -> dict:
    """One training step's uniforms, in the configuration's order: each
    level's stratified jitter [N, S + 1], then the [N, 3] background."""
    c = cfg["config"]
    jit = [torch.rand((n, s + 1), generator=generator, device=device)
           for s in sample_counts(c)]
    return {"jitters": jit,
            "background": torch.rand((n, 3), generator=generator, device=device)}


def forward(cfg, params, origins, directions, times, cams=None, *, train, step=0,
            jitters=None, background=None, update_proposals=True,
            dtype=F32, keep_points=False):
    """rgb [N, 3], accumulation [N], depth [N] (median), and for the
    losses each level's weights and s-space edges; with ``keep_points``
    each level's normalised points [N * S, 4] ("points").  ``cams``, the
    rays' camera indices, is unused: the field has no appearance
    embedding."""
    with no_tf32():
        return _forward(cfg, params, origins, directions, times, train, step,
                        jitters, background, update_proposals, dtype, keep_points)


def _forward(cfg, params, origins, directions, times, train, step, jitters,
             background, update_proposals, dtype, keep_points):
    c = cfg["config"]
    dev = origins.device
    aabb = torch.as_tensor(cfg["aabb"], dtype=dtype, device=dev)
    origins, directions = origins.to(dtype), directions.to(dtype)
    near, far = near_far(origins, directions, aabb)
    n = origins.shape[0]
    anneal = proposal_anneal(c, step) if train else 1.0
    counts = sample_counts(c)
    weights_list, edges_list, points = [], [], []
    weights = s_edges = None
    for level, count in enumerate(counts):
        jitter = jitters[level] if train else None
        if level == 0:
            s_edges = uniform_edges(count, jitter, n, dtype, dev)
        else:
            s_edges = pdf_edges(s_edges, torch.pow(weights, anneal), count, jitter)
        t = s_edges * far[:, None] + (1.0 - s_edges) * near[:, None]
        mids = (t[:, 1:] + t[:, :-1]) / 2.0
        deltas = t[:, 1:] - t[:, :-1]
        pos = origins[:, None, :] + directions[:, None, :] * mids[..., None]
        pts = normalized(pos.reshape(-1, 3), times.repeat_interleave(count), aabb)
        if keep_points:
            points.append(pts.detach())
        if level < len(counts) - 1:
            with torch.set_grad_enabled(torch.is_grad_enabled() and update_proposals):
                dens = proposal_density(
                    params["proposal_networks"][f"proposal_{level}"], pts, dtype)
            weights = volume_weights(dens.reshape(n, count), deltas)
        else:
            dens, rgb_s = field(params["fields"], pts, dtype)
            weights = volume_weights(dens.reshape(n, count), deltas)
            rgb_s = rgb_s.reshape(n, count, 3)
        weights_list.append(weights)
        edges_list.append(s_edges)
    acc = weights.sum(-1)
    if train:
        rgb = (weights[..., None] * rgb_s).sum(-2) + background.to(dtype) * (1.0 - acc[:, None])
    else:
        rgb_s = torch.nan_to_num(rgb_s)
        rgb = (weights[..., None] * rgb_s).sum(-2) + rgb_s[:, -1] * (1.0 - acc[:, None])
        rgb = torch.clamp(rgb, 0.0, 1.0)
    idx = torch.clamp((torch.cumsum(weights, -1) < 0.5).sum(-1), 0, counts[-1] - 1)
    t_mid = (t[:, 1:] + t[:, :-1]) / 2.0
    depth = t_mid.gather(-1, idx[:, None])[:, 0]
    out = {"rgb": rgb, "accumulation": acc, "depth": depth,
           "weights_list": weights_list, "edges_list": edges_list}
    if keep_points:
        out["points"] = points
    return out


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def interlevel_loss(weights_list, edges_list):
    """mip-NeRF 360's proposal loss: the field level's histogram (no
    gradient) against the mass each proposal histogram puts inside its
    bins."""
    c = edges_list[-1].detach()
    w = weights_list[-1].detach()
    total = 0.0
    for edges, wp in zip(edges_list[:-1], weights_list[:-1]):
        cw = torch.cat([torch.zeros_like(wp[:, :1]), torch.cumsum(wp, -1)], -1)
        starts, ends = edges[:, :-1], edges[:, 1:]
        lo = (starts[:, None, :] <= c[:, :-1, None]).sum(-1)
        hi = (ends[:, None, :] <= c[:, 1:, None]).sum(-1)
        inner = (cw.gather(-1, torch.clamp(hi, min=1))
                 - cw.gather(-1, torch.clamp(lo - 1, min=0)))
        total = total + torch.mean(torch.clamp(w - inner, min=0) ** 2 / (w + 1e-7))
    return total


def distortion_loss(weights, edges):
    mid = (edges[:, 1:] + edges[:, :-1]) / 2.0
    inter = (weights * (weights[:, None, :] * (mid[:, :, None] - mid[:, None, :]).abs()
                        ).sum(-1)).sum(-1)
    intra = (weights ** 2 * (edges[:, 1:] - edges[:, :-1])).sum(-1) / 3.0
    return torch.mean(inter + intra)


def _tv(t, only_w, dtype):
    t = t.to(BF16)
    h = torch.mean(torch.square((t[1:] - t[:-1]).to(dtype)))
    w = torch.mean(torch.square((t[:, 1:] - t[:, :-1]).to(dtype)))
    return w if only_w else h + w


def space_tv(scales, dtype):
    return sum(_tv(g, i not in SPACE_IDS, dtype)
               for planes in scales for i, g in enumerate(planes))


def time_smoothness(scales, dtype):
    total = 0.0
    for planes in scales:
        for i in TIME_IDS:
            t = planes[i].to(BF16)
            first = t[1:] - t[:-1]
            total = total + torch.mean(torch.square((first[1:] - first[:-1]).to(dtype)))
    return total


def sparse_transients(scales, dtype):
    return sum(torch.mean(torch.abs(1.0 - planes[i].to(dtype)))
               for planes in scales for i in TIME_IDS)


def loss_terms(cfg, params, out, image, dtype=F32) -> Dict[str, torch.Tensor]:
    """The scaled loss terms of a batch without target depths."""
    coef = cfg["config"]["loss_coefficients"]
    wl, el = out["weights_list"], out["edges_list"]
    field_grids = params["fields"]["grids"]
    prop_grids = [p["grids"][0] for p in params["proposal_networks"].values()]
    terms = {
        "rgb_loss": torch.mean((image.to(dtype) - out["rgb"]) ** 2),
        "distortion_loss": distortion_loss(wl[-1], el[-1]),
        "interlevel_loss": interlevel_loss(wl, el),
        "space_tv_loss": space_tv(field_grids, dtype),
        "space_tv_proposal_loss": space_tv(prop_grids, dtype),
        "sparse_transients_loss": sparse_transients(field_grids, dtype),
        "sparse_transients_proposal_loss": sparse_transients(prop_grids, dtype),
        "time_smoothness_loss": time_smoothness(field_grids, dtype),
        "time_smoothness_proposal_loss": time_smoothness(prop_grids, dtype),
    }
    return {k: v * coef.get(k, 1.0) for k, v in terms.items()}


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------

def schedule(sched: Optional[dict], count: int) -> float:
    f = np.float32
    if sched is None:
        return 1.0
    if count < sched["warm_up_end"]:
        return float(f(f(count) / f(max(sched["warm_up_end"], 1))))
    alpha = f(sched["learning_rate_alpha"])
    prog = np.clip((f(count) - f(sched["warm_up_end"]))
                   / f(max(sched["max_steps"] - sched["warm_up_end"], 1)), f(0), f(1))
    return float(f((np.cos(f(np.pi) * prog) + f(1)) * f(0.5) * (f(1) - alpha) + alpha))


class Adam:
    """Adam per param group as the configuration states it: the group's
    lr times its schedule at the update count before the update, bias
    corrections at the count after it, eps outside the root; the first
    moment stored in bf16 where ``moment_dtype`` says so."""

    def __init__(self, cfg: dict, params: dict):
        self.groups = {}
        for name, opt in cfg["optimizers"].items():
            ps = [p for _path, p in leaves(params[name])]
            mu_dtype = BF16 if opt.get("moment_dtype") == "bfloat16" else F32
            self.groups[name] = {
                "opt": opt, "params": ps, "count": 0,
                "mu": [torch.zeros_like(p, dtype=mu_dtype) for p in ps],
                "nu": [torch.zeros_like(p) for p in ps]}

    @torch.no_grad()
    def step(self, grads: Dict[str, List[Optional[torch.Tensor]]]):
        f = np.float32
        for name, g in self.groups.items():
            opt = g["opt"]
            step_size = float(f(-opt["lr"]) * f(schedule(opt.get("scheduler"), g["count"])))
            g["count"] += 1
            c1 = float(f(1) - f(B1) ** f(g["count"]))
            c2 = float(f(1) - f(B2) ** f(g["count"]))
            for p, gr, mu, nu in zip(g["params"], grads[name], g["mu"], g["nu"]):
                gr = torch.zeros_like(p) if gr is None else gr.to(F32)
                m = B1 * mu.to(F32) + (1.0 - B1) * gr
                v = B2 * nu + (1.0 - B2) * gr * gr
                p.add_((m / c1) / (torch.sqrt(v / c2) + opt["eps"]) * step_size)
                mu.copy_(m)
                nu.copy_(v)


def train_step(cfg, params, adam, batch_rays, image, step, step_draws, *,
               cams=None, dtype=F32, update_proposals=True):
    """One step in place: the loss terms, then Adam.  Returns (total loss,
    {group: [gradient per leaf]}) of the step, before the update."""
    origins, directions, times = batch_rays
    with torch.enable_grad():
        if dtype == F32:
            run_params = params
        else:
            run_params = _cast_tree(params, dtype)
        out = forward(cfg, run_params, origins, directions, times, train=True,
                      step=step, jitters=step_draws["jitters"],
                      background=step_draws["background"],
                      update_proposals=update_proposals, dtype=dtype)
        terms = loss_terms(cfg, run_params, out, image, dtype)
        loss = sum(list(terms.values())[1:], list(terms.values())[0])
        names = list(cfg["optimizers"])
        flat = [p for name in names for _path, p in leaves(params[name])]
        with no_tf32():
            grads = torch.autograd.grad(loss, flat, allow_unused=True)
    per_group, i = {}, 0
    for name in names:
        k = len(leaves(params[name]))
        per_group[name] = list(grads[i:i + k])
        i += k
    adam.step(per_group)
    return loss.detach().to(F32), per_group


def _cast_tree(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast_tree(v, dtype) for v in tree]
    return tree.to(dtype)


def requires_grad(params):
    for _path, p in leaves(params):
        p.requires_grad_(True)
    return params
