"""MLPs with a bf16 compute policy (counterpart of soccernerfs_tpu/ops/mlp.py).

Params stay f32; each layer rounds its operands to bf16 and multiplies
them in f32, which is what JAX's bf16 ``dot`` with
``preferred_element_type=f32`` computes.  A bf16 ``torch.matmul`` would
round its output to bf16 as well, an extra rounding the reference does not
make.  On the card, f32 matmuls must not use TF32, which would round the
operands to 10 mantissa bits: each layer's product, and its two backward
products (which autograd runs after ``mlp_apply`` has returned), turn
TF32 off and then restore the caller's setting.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from soccernerfs_tpu_torch.utils.device import full_f32

Params = dict


def init_mlp(
    in_dim: int,
    hidden_dim: int,
    num_hidden_layers: int,
    out_dim: int,
    generator: Optional[torch.Generator] = None,
    device=None,
) -> Params:
    """An MLP with ``num_hidden_layers`` hidden layers (0 = one linear
    map); weights and biases U(-1/sqrt(fan_in), 1/sqrt(fan_in)), as
    torch.nn.Linear.  Weights are [in, out] (the JAX layout)."""
    dims = [in_dim] + [hidden_dim] * num_hidden_layers + [out_dim]
    ws, bs = [], []
    for i in range(len(dims) - 1):
        bound = 1.0 / math.sqrt(dims[i])
        w = torch.rand((dims[i], dims[i + 1]), generator=generator) * 2 - 1
        b = torch.rand((dims[i + 1],), generator=generator) * 2 - 1
        ws.append((w * bound).to(device))
        bs.append((b * bound).to(device))
    return {"w": ws, "b": bs}


class _F32MatMul(torch.autograd.Function):
    """``a @ b`` of f32 [M, K] and [K, N], and its backward products, with
    TF32 off."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        with full_f32():
            return a @ b

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        with full_f32():
            ga = g @ b.t() if ctx.needs_input_grad[0] else None
            gb = a.t() @ g if ctx.needs_input_grad[1] else None
        return ga, gb


def mlp_apply(
    params: Params,
    x: torch.Tensor,
    activation: Optional[str] = "relu",
    output_activation: Optional[str] = None,
) -> torch.Tensor:
    """Apply an MLP; bf16 operands, f32 products and accumulation.

    Args:
        x: [..., in_dim].
        activation: hidden activation ("relu" | "none").
        output_activation: "sigmoid" | "relu" | None.
    Returns:
        [..., out_dim] float32.
    """
    lead = x.shape[:-1]
    h = x.reshape(-1, x.shape[-1]).to(torch.bfloat16)
    n = len(params["w"])
    for i, (w, b) in enumerate(zip(params["w"], params["b"])):
        h = _F32MatMul.apply(h.float(), w.to(torch.bfloat16).float()) + b
        is_last = i == n - 1
        act = output_activation if is_last else activation
        if act == "relu":
            h = torch.relu(h)
        elif act == "sigmoid":
            h = torch.sigmoid(h)
        elif act not in (None, "none"):
            raise ValueError(f"unknown activation {act}")
        if not is_last:
            h = h.to(torch.bfloat16)
    return h.float().reshape(*lead, h.shape[-1])
