"""Plain PyTorch reference of the ``nerfplayer-nerfacto`` configuration
(nerfbench/configs/nerfplayer-nerfacto.json): NeRFPlayer's temporal hash
grid on the nerfacto backbone behind two temporal hash-grid proposal
fields, as nerfstudio v0.1.19 (vendored by SoccerNeRFs) defines it, at the
precisions the configuration states.

Imports torch and numpy only.  It reads the configuration's own file and
the inputs the harness hands it; everything the program derives from them
(grid corners and hashed rows, the temporal channel tables, sample
points, proposal weights, the optimizer's state) is worked out again here.
The temporal channel tables are NeRFPlayer's sliding window of channels,
built as its published code builds them.

Precision, as the configuration states it: float32 with TF32 off, except
that each MLP layer rounds its operands to bf16 and multiplies them in
f32.  ``dtype=bfloat16`` computes everything in bf16 instead (the hash
tables read as bf16 values): the control.

Parameter layout (the program's): {"fields": {"grid": {"embeddings":
[rows, 2 + 64]}, "mlp_base_decode": {"w", "b"}, "appearance_embedding":
[images, 32], "mlp_head": {"w", "b"}}, "proposal_networks": {"proposal_i":
{"grid": {"embeddings": [rows, 2 + 32]}, "mlp": {"w", "b"}}}}.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional

import numpy as np
import torch

F32 = torch.float32
BF16 = torch.bfloat16
B1, B2 = 0.9, 0.999
PRIMES = (1, 2654435761, 805459861)
MASK32 = 0xFFFFFFFF
GEO_FEAT_DIM = 15
SH_DEGREE = 4
FIELD_LEVELS_RES = 1024      # the field grid's finest resolution
BASE_RES = 16


@contextlib.contextmanager
def no_tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


# ---------------------------------------------------------------------------
# grids
# ---------------------------------------------------------------------------

def grids(c: dict) -> List[dict]:
    """The field's grid, then each proposal field's: levels, channels a
    level, temporal channels, hashed rows, finest resolution, hash."""
    out = [{"levels": c["num_levels"], "level_dim": c["features_per_level"],
            "temporal": c["temporal_dim"], "log2": c["log2_hashmap_size"],
            "max_res": FIELD_LEVELS_RES, "hash": "xor"}]
    for a in c["proposal_net_args_list"]:
        out.append({"levels": a["num_levels"], "level_dim": 2, "temporal": a["temporal_dim"],
                    "log2": a["log2_hashmap_size"], "max_res": a["max_res"], "hash": "zline"})
    return out


def layout(g: dict):
    """(row offsets [L + 1], scales [L], resolutions [L]) of a grid: level
    l has scale s^l * 16 - 1 (s: 16 to the finest resolution over the
    levels), resolution ceil(scale) + 1 and min(2^log2, resolution^3) rows,
    rounded up to a multiple of 8."""
    s = float(np.exp2(np.log2(g["max_res"] / BASE_RES) / max(g["levels"] - 1, 1)))
    offsets, scales, res = [0], [], []
    for lvl in range(g["levels"]):
        scale = s ** lvl * BASE_RES - 1.0
        r = int(np.ceil(scale)) + 1
        rows = int(np.ceil(min(2 ** g["log2"], r ** 3) / 8) * 8)
        offsets.append(offsets[-1] + rows)
        scales.append(scale)
        res.append(r)
    return offsets, scales, res


def temporal_tables(level_dim: int, temporal: int):
    """NeRFPlayer's sliding channel window: per temporal row (T - 1 rows),
    for each output channel two picks (channel, time weight slot), and the
    row's channel list whose first two entries the temporal TV pairs."""
    index = [np.asarray([0, level_dim] + list(range(1, level_dim)), np.int64)]
    base = list(range(2, level_dim + 1))
    permute = [np.asarray([0] + base, np.int64)]
    last = 0
    entries = [(index[0], permute[0], last)]
    for _ in range(1, temporal - 1):
        last = (last + 1) % level_dim
        hi, lo = int(index[-1].max()), int(index[-1].min())
        perm = permute[-1].copy()
        perm[perm == 0] += 1
        prev = index[-1][1:][perm - 1].tolist()
        prev.pop(last)
        index.append(np.asarray([lo + 1, hi + 1] + prev, np.int64))
        permute.append(np.asarray(base[:last] + [0] + base[last:], np.int64))
        entries.append((index[-1], permute[-1], last))
    picks, slots = [], []
    for idx, perm, lst in entries:
        ch = idx[perm]                      # each output channel's first pick
        second = np.zeros_like(ch)
        second[lst] = idx[1]
        picks.append(np.stack([ch, second], 1))
        slot = np.full((level_dim, 2), -1, np.int64)   # -1: weight 1 (a), 0 (b)
        slot[lst] = (0, 1)                  # the window's last channel mixes
        slots.append(slot)
    return np.stack(picks), np.stack(slots), np.stack(index)


def time_picks(g: dict, times: torch.Tensor):
    """Per point the channels [B, C, 2] and their time weights [B, C, 2]."""
    picks, slots, _ = temporal_tables(g["level_dim"], g["temporal"])
    n_rows = picks.shape[0]
    v = times.float() * (n_rows - 1)
    row = torch.clamp(torch.floor(v).long(), 0, n_rows - 1)
    dev = times.device
    ch = torch.as_tensor(picks, device=dev)[row]
    slot = torch.as_tensor(slots, device=dev)[row]
    wa = (row + 1 - v)[:, None, None]
    wb = (v - row)[:, None, None]
    w = torch.where(slot == 0, wa, torch.where(slot == 1, wb, (slot == -1).float()
                                               * torch.tensor([1.0, 0.0], device=dev)))
    return ch, w


def corner_rows(g: dict, xyz: torch.Tensor):
    """Per level the table rows [8, B] and trilinear weights [8, B] of the
    points ``xyz`` [B, 3] in [0, 1]: corners floor(x s + 1/2) + {0, 1}^3,
    a level whose dense grid fits its rows indexed by strides, else
    hashed (xor of the coordinates times primes, or with ``zline`` the
    last coordinate added to the hash of the others); corner k's offset in
    dimension d is bit 2 - d of k."""
    offsets, scales, res = layout(g)
    out = []
    bits = torch.tensor([[(k >> (2 - d)) & 1 for d in range(3)] for k in range(8)],
                        device=xyz.device)
    for lvl in range(g["levels"]):
        rows = offsets[lvl + 1] - offsets[lvl]
        pos = xyz.float() * torch.tensor(scales[lvl], dtype=torch.float32) + 0.5
        p0 = torch.floor(pos)
        frac = pos - p0
        c = p0.long()[None, :, :] + bits[:, None, :]          # [8, B, 3]
        if res[lvl] ** 3 <= rows:
            idx = (c[..., 0] * res[lvl] + c[..., 1]) * res[lvl] + c[..., 2]
            idx = torch.remainder(idx, rows)
        elif g["hash"] == "xor":
            h = c[..., 0] & MASK32
            for d in (1, 2):
                h = h ^ ((c[..., d] * PRIMES[d]) & MASK32)
            idx = torch.remainder(h, rows)
        else:
            h = ((c[..., 0] * PRIMES[1]) & MASK32) ^ ((c[..., 1] * PRIMES[2]) & MASK32)
            idx = torch.fmod(torch.remainder(h, rows) + c[..., 2], rows)
        idx = idx + offsets[lvl]
        if g["hash"] == "zline":
            idx = torch.remainder(idx, offsets[-1])
        wts = torch.where(bits[:, None, :] == 1, frac[None], 1.0 - frac[None]).prod(-1)
        out.append((idx, wts))
    return out


def encode(g: dict, table, xyz, times, dtype=F32):
    """[B, levels * C] temporal hash features: per level the corners'
    weighted sum of each picked channel, then the picks' time weights."""
    ch, tw = time_picks(g, times)                             # [B, C, 2]
    width = table.shape[1]
    flat = table.reshape(-1)
    feats = []
    for idx, wts in corner_rows(g, xyz.detach()):
        acc = 0.0
        for k in range(8):
            vals = flat[idx[k][:, None, None] * width + ch]   # [B, C, 2]
            acc = acc + wts[k].to(dtype)[:, None, None] * vals
        feats.append((acc * tw.to(dtype)).sum(-1))
    return torch.cat(feats, -1)


def spherical_harmonics(d):
    """The 16 real SH basis values of degree 4 at unit directions."""
    x, y, z = d[:, 0], d[:, 1], d[:, 2]
    xx, yy, zz = x * x, y * y, z * z
    return torch.stack([
        torch.full_like(x, 0.28209479177387814),
        0.4886025119029199 * y, 0.4886025119029199 * z, 0.4886025119029199 * x,
        1.0925484305920792 * x * y, 1.0925484305920792 * y * z,
        0.9461746957575601 * zz - 0.31539156525252005, 1.0925484305920792 * x * z,
        0.5462742152960396 * (xx - yy),
        0.5900435899266435 * y * (3.0 * xx - yy), 2.890611442640554 * x * y * z,
        0.4570457994644658 * y * (5.0 * zz - 1.0), 0.3731763325901154 * z * (5.0 * zz - 3.0),
        0.4570457994644658 * x * (5.0 * zz - 1.0), 1.445305721320277 * z * (xx - yy),
        0.5900435899266435 * x * (xx - 3.0 * yy)], -1)


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

def mlp_widths(cfg: dict) -> Dict[str, list]:
    c = cfg["config"]
    feats = c["num_levels"] * c["features_per_level"]
    head_in = GEO_FEAT_DIM + SH_DEGREE ** 2 + c["appearance_embedding_dim"]
    return {"mlp_base_decode": [feats, c["hidden_dim"], 1 + GEO_FEAT_DIM],
            "mlp_head": [head_in, c["hidden_dim_color"], c["hidden_dim_color"], 3]}


def _param_specs(cfg: dict):
    """[(path, shape, kind)] in the program's leaf order: kind
    ("uniform", a, b), ("normal",) or ("mlp", fan_in)."""
    c = cfg["config"]
    gs = grids(c)
    specs = []

    def mlp(prefix, dims):
        for key in ("w", "b"):
            for i in range(len(dims) - 1):
                shape = (dims[i], dims[i + 1]) if key == "w" else (dims[i + 1],)
                specs.append((prefix + (key, i), shape, ("mlp", dims[i])))

    widths = mlp_widths(cfg)
    specs.append((("fields", "grid", "embeddings"),
                  (layout(gs[0])[0][-1], gs[0]["level_dim"] + gs[0]["temporal"]),
                  ("uniform", -1e-4, 1e-4)))
    mlp(("fields", "mlp_base_decode"), widths["mlp_base_decode"])
    specs.append((("fields", "appearance_embedding"),
                  (cfg["num_images"], c["appearance_embedding_dim"]), ("normal",)))
    mlp(("fields", "mlp_head"), widths["mlp_head"])
    for i, (g, a) in enumerate(zip(gs[1:], c["proposal_net_args_list"])):
        prefix = ("proposal_networks", f"proposal_{i}")
        specs.append((prefix + ("grid", "embeddings"),
                      (layout(g)[0][-1], g["level_dim"] + g["temporal"]),
                      ("uniform", -1e-4, 1e-4)))
        mlp(prefix + ("mlp",), [g["levels"] * g["level_dim"], a["hidden_dim"], 1])
    return specs


def _put(tree, path, value):
    node = tree
    for key, nxt in zip(path[:-1], path[1:]):
        if isinstance(node, dict):
            node = node.setdefault(key, [] if isinstance(nxt, int) else {})
        else:
            if key >= len(node):
                node.append([] if isinstance(nxt, int) else {})
            node = node[key]
    if isinstance(node, dict):
        node[path[-1]] = value
    else:
        node.append(value)


def make_params(cfg: dict, seed: int, device) -> dict:
    """The configuration's initial weights from ``seed``: hash tables
    U(-1e-4, 1e-4), the appearance embedding N(0, 1), MLP weights and
    biases U(-1/sqrt(fan_in), 1/sqrt(fan_in)); two draws on the device."""
    specs = _param_specs(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2**63)
    total = sum(math.prod(s) for _p, s, k in specs if k[0] != "normal")
    normal = sum(math.prod(s) for _p, s, k in specs if k[0] == "normal")
    u = torch.rand(total, generator=gen, device=device)
    z = torch.randn(normal, generator=gen, device=device)
    tree: dict = {}
    at = zt = 0
    for path, shape, kind in specs:
        n = math.prod(shape)
        if kind[0] == "normal":
            leaf = z[zt:zt + n].view(shape).clone()
            zt += n
        else:
            leaf = u[at:at + n].view(shape)
            at += n
            if kind[0] == "uniform":
                leaf.mul_(kind[2] - kind[1]).add_(kind[1])
            else:
                leaf.mul_(2.0).sub_(1.0).mul_(1.0 / math.sqrt(kind[1]))
            leaf = leaf.clone()
        _put(tree, path, leaf)
    del u, z
    return tree


def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in leaves(v, f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in leaves(v, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def requires_grad(params):
    for _p, t in leaves(params):
        t.requires_grad_(True)
    return params


# ---------------------------------------------------------------------------
# fields
# ---------------------------------------------------------------------------

class _TruncExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(torch.clamp(x, -15.0, 15.0))


def bf16_round(t):
    return t.to(BF16).to(t.dtype) if t.dtype != BF16 else t


def mlp(params, x, act, out_act, dtype):
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


def normalized(positions, aabb):
    return (positions - aabb[0]) / (aabb[1] - aabb[0])


def proposal_density(g, params, pts, times, dtype):
    feats = encode(g, params["grid"]["embeddings"], pts, times, dtype)
    return _TruncExp.apply(mlp(params["mlp"], feats, "relu", None, dtype)[:, 0])


def field(cfg, g, params, pts, times, directions, cams, train, dtype):
    feats = encode(g, params["grid"]["embeddings"], pts, times, dtype)
    out = mlp(params["mlp_base_decode"], feats, "relu", None, dtype)
    density, geo = _TruncExp.apply(out[:, 0]), out[:, 1:]
    emb = params["appearance_embedding"]
    emb = emb[cams.long()] if train else emb.mean(0).expand(pts.shape[0], -1)
    h = torch.cat([spherical_harmonics(directions), geo, emb.to(geo.dtype)], -1)
    return density, mlp(params["mlp_head"], h, "relu", "sigmoid", dtype)


# ---------------------------------------------------------------------------
# rays, samples, the model (as the k-planes reference; uniform spacing
# between the scene box's near and far, one jitter a ray)
# ---------------------------------------------------------------------------

def rays(c2w, fx, fy, cx, cy, times, coords):
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
    e = torch.linspace(0.0, 1.0, num_samples + 1, device=device, dtype=dtype)[None]
    if jitter is None:
        return e.expand(n, num_samples + 1)
    mid = (e[:, 1:] + e[:, :-1]) / 2.0
    upper = torch.cat([mid, e[:, -1:]], -1)
    lower = torch.cat([e[:, :1], mid], -1)
    return lower + (upper - lower) * jitter.to(dtype)


def pdf_edges(s_edges, weights, num_samples, jitter):
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
    """One training step's draws, in the configuration's order: each
    level's one jitter a ray [N, 1], the [N, 3] background, then one
    temporal-TV row per grid (the field's, then each proposal field's)."""
    c = cfg["config"]
    jit = [torch.rand((n, 1), generator=generator, device=device) for _ in sample_counts(c)]
    bg = torch.rand((n, 3), generator=generator, device=device)
    tv = [torch.randint(0, g["temporal"] - 1, (), generator=generator, device=device)
          for g in grids(c)]
    return {"jitters": jit, "background": bg, "tv_rows": tv}


def forward(cfg, params, origins, directions, times, cams=None, *, train, step=0,
            jitters=None, background=None, update_proposals=True, dtype=F32,
            keep_points=False):
    with no_tf32():
        return _forward(cfg, params, origins, directions, times, cams, train, step,
                        jitters, background, update_proposals, dtype, keep_points)


def _forward(cfg, params, origins, directions, times, cams, train, step, jitters,
             background, update_proposals, dtype, keep_points):
    c = cfg["config"]
    gs = grids(c)
    dev = origins.device
    aabb = torch.as_tensor(cfg["aabb"], dtype=dtype, device=dev)
    origins, directions = origins.to(dtype), directions.to(dtype)
    near, far = near_far(origins, directions, aabb)
    n = origins.shape[0]
    anneal = proposal_anneal(c, step) if train else 1.0
    counts = sample_counts(c)
    weights_list, edges_list, points = [], [], []
    weights = None
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
        pts = normalized(pos.reshape(-1, 3), aabb)
        tms = times.repeat_interleave(count)
        if keep_points:
            points.append((pts.detach(), tms))
        if level < len(counts) - 1:
            with torch.set_grad_enabled(torch.is_grad_enabled() and update_proposals):
                dens = proposal_density(gs[level + 1],
                                        params["proposal_networks"][f"proposal_{level}"],
                                        pts, tms, dtype)
        else:
            dirs = directions[:, None, :].expand(n, count, 3).reshape(-1, 3)
            cam = None if cams is None else cams.repeat_interleave(count)
            dens, rgb_s = field(cfg, gs[0], params["fields"], pts, tms, dirs, cam, train, dtype)
            rgb_s = rgb_s.reshape(n, count, 3)
        weights = volume_weights(dens.reshape(n, count), deltas)
        weights_list.append(weights)
        edges_list.append(s_edges)
    acc = weights.sum(-1)
    bg = background.to(dtype) if train else _eval_background(n, dev).to(dtype)
    rgb = (weights[..., None] * (rgb_s if train else torch.nan_to_num(rgb_s))).sum(-2)
    rgb = rgb + bg * (1.0 - acc[:, None])
    if not train:
        rgb = torch.clamp(rgb, 0.0, 1.0)
    idx = torch.clamp((torch.cumsum(weights, -1) < 0.5).sum(-1), 0, counts[-1] - 1)
    depth = ((t[:, 1:] + t[:, :-1]) / 2.0).gather(-1, idx[:, None])[:, 0]
    out = {"rgb": rgb, "accumulation": acc, "depth": depth,
           "weights_list": weights_list, "edges_list": edges_list}
    if keep_points:
        out["points"] = points
    return out


def _eval_background(n, device):
    """The random background outside training: draws of a generator
    seeded with 0."""
    return torch.rand((n, 3), generator=torch.Generator(device=device).manual_seed(0),
                      device=device)


# ---------------------------------------------------------------------------
# losses and the optimizer
# ---------------------------------------------------------------------------

def interlevel_loss(weights_list, edges_list):
    c = edges_list[-1].detach()
    w = weights_list[-1].detach()
    total = 0.0
    for edges, wp in zip(edges_list[:-1], weights_list[:-1]):
        cw = torch.cat([torch.zeros_like(wp[:, :1]), torch.cumsum(wp, -1)], -1)
        lo = (edges[:, None, :-1] <= c[:, :-1, None]).sum(-1)
        hi = (edges[:, None, 1:] <= c[:, 1:, None]).sum(-1)
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


def temporal_tv(g, table, row, dtype):
    """Mean over the table's rows of |T[:, i0] - T[:, i1]|, (i0, i1) the
    first two channels of the temporal row ``row``."""
    index = torch.as_tensor(temporal_tables(g["level_dim"], g["temporal"])[2],
                            device=table.device)
    pair = index[row, :2]
    cols = table.to(dtype).index_select(1, pair)
    return torch.mean(torch.abs(cols[:, 0] - cols[:, 1]))


def loss_terms(cfg, params, out, image, tv_rows, dtype=F32) -> Dict[str, torch.Tensor]:
    c = cfg["config"]
    gs = grids(c)
    wl, el = out["weights_list"], out["edges_list"]
    tv = temporal_tv(gs[0], params["fields"]["grid"]["embeddings"], tv_rows[0], dtype)
    for i, row in enumerate(tv_rows[1:]):
        tv = tv + temporal_tv(gs[i + 1], params["proposal_networks"][f"proposal_{i}"]["grid"]
                              ["embeddings"], row, dtype)
    return {
        "rgb_loss": torch.mean((image.to(dtype) - out["rgb"]) ** 2),
        "interlevel_loss": c["interlevel_loss_mult"] * interlevel_loss(wl, el),
        "distortion_loss": c["distortion_loss_mult"] * distortion_loss(wl[-1], el[-1]),
        "temporal_tv_loss": tv * c["temporal_tv_weight"],
    }


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
    """Adam per param group, f32 moments (as the k-planes reference's)."""

    def __init__(self, cfg: dict, params: dict):
        self.groups = {}
        for name, opt in cfg["optimizers"].items():
            ps = [p for _path, p in leaves(params[name])]
            mu_dtype = BF16 if opt.get("moment_dtype") == "bfloat16" else F32
            self.groups[name] = {"opt": opt, "params": ps, "count": 0,
                                 "mu": [torch.zeros_like(p, dtype=mu_dtype) for p in ps],
                                 "nu": [torch.zeros_like(p) for p in ps]}

    @torch.no_grad()
    def step(self, grads):
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


def _cast_tree(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast_tree(v, dtype) for v in tree]
    return tree.to(dtype)


def train_step(cfg, params, adam, batch_rays, image, step, step_draws, *,
               cams=None, dtype=F32, update_proposals=True):
    """One step in place; returns (loss, {group: [gradient per leaf]})."""
    origins, directions, times = batch_rays
    with torch.enable_grad():
        run_params = params if dtype == F32 else _cast_tree(params, dtype)
        out = forward(cfg, run_params, origins, directions, times, cams, train=True,
                      step=step, jitters=step_draws["jitters"],
                      background=step_draws["background"],
                      update_proposals=update_proposals, dtype=dtype)
        terms = loss_terms(cfg, run_params, out, image, step_draws["tv_rows"], dtype)
        vals = list(terms.values())
        loss = sum(vals[1:], vals[0])
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
