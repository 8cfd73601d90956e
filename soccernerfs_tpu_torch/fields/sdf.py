"""SDF field for surface models (counterpart of soccernerfs_tpu/fields/sdf.py).

An MLP from NeRF-encoded positions to (sdf, geo features), geometrically
initialised; a colour head on points, encoded directions, normals and
features; NeuS's single learned deviation.  Normals are the SDF's
gradient in the positions (``torch.autograd.grad``), kept in the graph in
training, so that the colour and eikonal losses reach the params through
them (a double backward).

The SDF MLP is f32 ``h @ w + b`` throughout, as in the JAX version (not
``mlp_apply``'s bf16 policy); its softplus is JAX's
``logaddexp(100 h, 0) / 100``, values and derivative rule
(``_LogAddExp0``), not ``F.softplus(beta=100)``, whose threshold of 20
switches to the identity.  Callers run
it with TF32 off (``utils.device.full_f32``), so that every order of its
derivatives is f32.  The colour MLP is ``mlp_apply``'s, bf16 operands,
as JAX's default compute dtype gives it.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from soccernerfs_tpu_torch.ops.encodings import nerf_encoding
from soccernerfs_tpu_torch.ops.mlp import mlp_apply


@dataclass(frozen=True)
class SDFFieldConfig:
    """Field names and defaults are the JAX package's
    (its ``fields/sdf.SDFFieldConfig``)."""

    num_layers: int = 8
    hidden_dim: int = 256
    geo_feat_dim: int = 256
    num_layers_color: int = 4
    hidden_dim_color: int = 256
    position_encoding_freqs: int = 6
    direction_encoding_freqs: int = 4
    bias: float = 0.8  # the initial sphere's radius
    inside_outside: bool = False
    beta_init: float = 0.1  # the deviation's initial value

    @property
    def pos_enc_dim(self) -> int:
        return 3 + 3 * self.position_encoding_freqs * 2

    @property
    def dir_enc_dim(self) -> int:
        return 3 + 3 * self.direction_encoding_freqs * 2


def sdf_mlp_dims(cfg: SDFFieldConfig) -> list:
    """The SDF MLP's layer widths, input first."""
    return ([cfg.pos_enc_dim] + [cfg.hidden_dim] * (cfg.num_layers - 1)
            + [1 + cfg.geo_feat_dim])


def color_mlp_dims(cfg: SDFFieldConfig) -> list:
    """The colour MLP's layer widths, input first: points, encoded
    directions, normals, features."""
    return ([3 + cfg.dir_enc_dim + 3 + cfg.geo_feat_dim]
            + [cfg.hidden_dim_color] * (cfg.num_layers_color - 1) + [3])


def geometric_init(cfg: SDFFieldConfig, normal, uniform, zeros) -> dict:
    """The field's params from draws: ``normal(shape)`` N(0, 1),
    ``uniform(shape, lo, hi)`` and ``zeros(shape)``, arrays of one
    framework (numpy or torch).

    The JAX init's distribution: hidden layers N(0, 2 / fan_out); the last
    layer's sdf column sqrt(pi / fan_in) + N(0, 1e-8), its feature columns
    N(0, 2e-4 / (fan_out - 1)), its sdf bias -bias (+bias inside-out); the
    colour layers U(+-1/sqrt(fan_in)) with zero biases; the deviation
    ``beta_init``.  The first layer sees the raw position only: its
    encoding rows are zero, as the JAX init's docstring says, so that the
    field starts as a sphere's SDF, ~|x| - bias.  (The JAX init zeroes the
    rows from the fourth on, but its encoding puts the raw position last:
    its first layer keeps x's three lowest sinusoids instead, and its
    field starts as a function of x alone.)"""
    dims = sdf_mlp_dims(cfg)
    ws, bs = [], []
    for i in range(len(dims) - 1):
        fan_in, fan_out = dims[i], dims[i + 1]
        if i == len(dims) - 2:
            w = normal((fan_in, fan_out))
            w[:, :1] = math.sqrt(math.pi) / math.sqrt(fan_in) + 1e-4 * w[:, :1]
            w[:, 1:] = w[:, 1:] * math.sqrt(2) / math.sqrt(fan_out - 1) * 1e-2
            b = zeros((fan_out,))
            b[0] = (1.0 if cfg.inside_outside else -1.0) * cfg.bias
        else:
            w = normal((fan_in, fan_out)) * math.sqrt(2.0 / fan_out)
            if i == 0:
                # the encoding's rows: the raw position is its last three
                w[:-3, :] = 0.0
            b = zeros((fan_out,))
        ws.append(w)
        bs.append(b)
    cdims = color_mlp_dims(cfg)
    cws = [uniform((cdims[i], cdims[i + 1]), -1.0 / math.sqrt(cdims[i]),
                   1.0 / math.sqrt(cdims[i])) for i in range(len(cdims) - 1)]
    cbs = [zeros((d,)) for d in cdims[1:]]
    return {"sdf_mlp": {"w": ws, "b": bs}, "color_mlp": {"w": cws, "b": cbs},
            "deviation": cfg.beta_init}


def init_sdf_field(cfg: SDFFieldConfig,
                   generator: Optional[torch.Generator] = None,
                   device=None) -> dict:
    """``geometric_init`` drawn with torch, f32 on ``device``."""
    def normal(shape):
        return torch.randn(shape, generator=generator)

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=generator) * (hi - lo) + lo

    params = geometric_init(cfg, normal, uniform, torch.zeros)
    params["deviation"] = torch.tensor(params["deviation"])

    def to(x):
        if isinstance(x, dict):
            return {k: to(v) for k, v in x.items()}
        if isinstance(x, list):
            return [to(v) for v in x]
        return x.float().to(device)

    return to(params)


class _LogAddExp0(torch.autograd.Function):
    """``logaddexp(x, 0)`` as ``jnp.logaddexp`` computes it: max(x, 0) +
    log1p(exp(-|x|)), and its derivative by JAX's rule, exp(x - y) with
    y the output.  The backward is itself differentiable (through x and
    y), so every order of derivative is JAX's: the second is
    exp(x - y) * (1 - exp(x - y)), exactly 0 where y rounds to x.
    (``torch.logaddexp``'s second derivative is NaN below x = -88;
    ``F.softplus``' threshold differs from it.)"""

    @staticmethod
    def forward(ctx, x):
        y = torch.relu(x) + torch.log1p(torch.exp(-torch.abs(x)))
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        return g * torch.exp(x - y)


def _softplus100(h: torch.Tensor) -> torch.Tensor:
    """softplus(100 h) / 100 as JAX's ``logaddexp(100 h, 0) / 100``."""
    return _LogAddExp0.apply(100.0 * h) / 100.0


def sdf_mlp(cfg: SDFFieldConfig, params: dict, positions: torch.Tensor
            ) -> torch.Tensor:
    """[M, 3] -> [M, 1 + geo_feat_dim]: f32 layers with the softplus
    between them."""
    h = nerf_encoding(positions, cfg.position_encoding_freqs, 0.0,
                      cfg.position_encoding_freqs - 1, include_input=True)
    mlp = params["sdf_mlp"]
    n = len(mlp["w"])
    for i, (w, b) in enumerate(zip(mlp["w"], mlp["b"])):
        h = h @ w + b
        if i < n - 1:
            h = _softplus100(h)
    return h


def sdf_and_features(cfg: SDFFieldConfig, params: dict,
                     positions: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """sdf [M] and geo features [M, geo_feat_dim]."""
    out = sdf_mlp(cfg, params, positions)
    return out[..., 0], out[..., 1:]


def sdf_value(cfg: SDFFieldConfig, params: dict, positions: torch.Tensor
              ) -> torch.Tensor:
    return sdf_and_features(cfg, params, positions)[0]


def sdf_features_and_normals(cfg: SDFFieldConfig, params: dict,
                             positions: torch.Tensor, create_graph: bool
                             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """sdf [M], features [M, F] and the SDF's gradient in the positions
    [M, 3] (the unnormalised normals), from one forward.  Positions that
    require grad (the camera optimizer's: the sampler's distances are
    constants, the rays are not) keep it, through all three outputs, as
    the JAX package's ``jax.grad`` of the sdf keeps it; others are taken
    as constants.  With ``create_graph`` the gradient stays in the graph,
    so that a loss on it or on what it feeds reaches the params (a double
    backward); the gradient is computed whatever the caller's grad mode (a
    render runs under ``no_grad``), never under ``inference_mode``."""
    with torch.enable_grad():
        p = (positions if positions.requires_grad
             else positions.detach().requires_grad_(True))
        sdf, feats = sdf_and_features(cfg, params, p)
        (normals,) = torch.autograd.grad(sdf.sum(), p,
                                         create_graph=create_graph)
    return sdf, feats, normals


def sdf_normals(cfg: SDFFieldConfig, params: dict, positions: torch.Tensor,
                create_graph: bool = False) -> torch.Tensor:
    """The SDF's gradient in the positions, [M, 3]."""
    return sdf_features_and_normals(cfg, params, positions, create_graph)[2]


def sdf_rgb(cfg: SDFFieldConfig, params: dict, positions: torch.Tensor,
            directions: torch.Tensor, normals: torch.Tensor,
            features: torch.Tensor) -> torch.Tensor:
    """Colour [M, 3] from points, NeRF-encoded directions, (unit) normals
    and geo features."""
    de = nerf_encoding(directions, cfg.direction_encoding_freqs, 0.0,
                       cfg.direction_encoding_freqs - 1, include_input=True)
    h = torch.cat([positions, de, normals, features], dim=-1)
    return mlp_apply(params["color_mlp"], h, activation="relu",
                     output_activation="sigmoid")


def inv_s(params: dict) -> torch.Tensor:
    """NeuS's inverse deviation, exp(10 * deviation)."""
    return torch.exp(10.0 * params["deviation"])
