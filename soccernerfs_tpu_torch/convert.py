"""Parameters between the JAX package and the port.

``params_from_jax`` takes the parameter pytree of the JAX package's
``models/kplanes.init``, mapped to numpy arrays (``jax.tree_util.tree_map(
np.asarray, params)``), and returns the port's params: the same nested
dicts and lists, with torch tensors on a device.  Both packages then
compute the same function.

``seeded_params`` makes such a numpy tree without JAX, from a numpy seed
(for runs on machines that have no JAX, like the card's).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from soccernerfs_tpu_torch.fields.kplanes import (
    field_mlp_dims,
    plane_combinations,
    proposal_mlp_dims,
    scale_resolutions,
)
from soccernerfs_tpu_torch.models import kplanes
from soccernerfs_tpu_torch.utils.device import resolve_device


def params_from_jax(np_tree, device=None):
    """Port params from a numpy pytree in the JAX package's layout, on
    ``device`` (default CUDA; raises when CUDA is absent and the caller
    did not ask for another device)."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [conv(v) for v in x]
        # a copy: arrays mapped from JAX are read-only
        return torch.from_numpy(np.array(x, copy=True)).to(dev)

    return conv(np_tree)


def seeded_params(cfg: kplanes.Config, seed: int, num_train_data: int = 0,
                  time_noise: float = 0.0) -> dict:
    """A numpy param tree in the layout of the JAX package's
    ``kplanes.init(rng, cfg, num_train_data)``, drawn with numpy.

    Space planes U(0.1, 0.5) (proposal planes U(0.1, 0.15)), time planes
    1 + U(-time_noise, time_noise), MLP weights and biases
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)), as the JAX init draws them.
    """
    rng = np.random.default_rng(seed)

    def planes(feat, reso, a, b):
        out = []
        for c1, c2 in plane_combinations(len(reso)):
            shape = (reso[c2], reso[c1], feat)
            if len(reso) == 4 and 3 in (c1, c2):
                g = 1.0 + rng.uniform(-time_noise, time_noise, shape)
            else:
                g = rng.uniform(a, b, shape)
            out.append(g.astype(np.float32))
        return out

    def mlp(in_dim, hidden, layers, out_dim):
        dims = [in_dim] + [hidden] * layers + [out_dim]
        ws, bs = [], []
        for i in range(len(dims) - 1):
            bound = 1.0 / math.sqrt(dims[i])
            ws.append(rng.uniform(-bound, bound, (dims[i], dims[i + 1]))
                      .astype(np.float32))
            bs.append(rng.uniform(-bound, bound, (dims[i + 1],))
                      .astype(np.float32))
        return {"w": ws, "b": bs}

    fcfg = cfg.field_config(num_train_data)
    fields = {"grids": [planes(fcfg.feat_dim, reso, 0.1, 0.5)
                        for reso in scale_resolutions(fcfg)]}
    for name, dims in field_mlp_dims(fcfg).items():
        fields[name] = mlp(*dims)
    if fcfg.use_appearance_embedding:
        fields["appearance_embedding"] = rng.standard_normal(
            (fcfg.num_images, fcfg.appearance_dim)).astype(np.float32)

    props = {}
    for idx, dcfg in cfg.density_field_configs():
        name = f"proposal_{idx}"
        if name not in props:
            props[name] = {
                "grids": [planes(dcfg.feature_dim, dcfg.resolution, 0.1, 0.15)],
                "sigma_net": mlp(*proposal_mlp_dims(dcfg)),
            }
    return {"fields": fields, "proposal_networks": props}
