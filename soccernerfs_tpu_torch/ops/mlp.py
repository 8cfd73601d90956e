"""MLPs with a bf16 compute policy (counterpart of soccernerfs_tpu/ops/mlp.py).

Params stay f32; each layer rounds its operands to bf16 and multiplies
them in f32, which is what JAX's bf16 ``dot`` with
``preferred_element_type=f32`` computes.  A bf16 ``torch.matmul`` would
round its output to bf16 as well, an extra rounding the reference does not
make.  On the card, f32 matmuls must not use TF32, which would round the
operands to 10 mantissa bits: ``mlp_apply`` turns it off for every CUDA
input, and it stays off for the backward products that follow.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

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
    if x.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
    h = x.to(torch.bfloat16)
    n = len(params["w"])
    for i, (w, b) in enumerate(zip(params["w"], params["b"])):
        h = torch.matmul(h.float(), w.to(torch.bfloat16).float()) + b
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
    return h.float()
