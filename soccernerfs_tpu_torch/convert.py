"""Parameters between the JAX package and the port.

``params_from_jax`` takes the parameter pytree of a JAX model's ``init``
(``models/kplanes``, ``models/nerfacto`` and ``models/depth_nerfacto``,
whose params are nerfacto's, ``models/nerfplayer_nerfacto``,
``models/instant_ngp``, ``models/nerfplayer_ngp``, ``models/nerfplayer``,
``models/nerfplayer_ngp_complete``, ``models/vanilla_nerf``,
``models/mipnerf``, ``models/tensorf``, ``models/semantic_nerfw`` (with
its ``fields.mlp_semantics``), ``models/neus`` (the SDF field's
``sdf_mlp``, ``color_mlp`` and the scalar ``deviation``); with the trainer's
``camera_opt`` group or without), mapped to numpy arrays
(``jax.tree_util.tree_map(np.asarray, params)``), and returns the port's
params: the same nested dicts and lists, with torch tensors on a device.
Both packages then compute the same function.  ``aux_from_jax`` does the
same for a model's non-trainable state (the occupancy models' ``{"occs":
[R^3]}``).

``seeded_params`` makes such a numpy tree without JAX, from a numpy seed
(for runs on machines that have no JAX).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from soccernerfs_tpu_torch.fields import instant_ngp as ingp_field
from soccernerfs_tpu_torch.fields import kplanes as kplanes_field
from soccernerfs_tpu_torch.fields import nerfacto as nerfacto_field
from soccernerfs_tpu_torch.fields import nerfplayer as np_field
from soccernerfs_tpu_torch.fields import nerfplayer_nerfacto as npn_field
from soccernerfs_tpu_torch.fields import nerfplayer_ngp as npngp_field
from soccernerfs_tpu_torch.fields import sdf as sdf_field
from soccernerfs_tpu_torch.fields import vanilla_nerf as vnerf_field
from soccernerfs_tpu_torch.models import (
    instant_ngp,
    kplanes,
    mipnerf,
    nerfacto,
    nerfplayer,
    nerfplayer_nerfacto,
    nerfplayer_ngp,
    nerfplayer_ngp_complete,
    neus,
    semantic_nerfw,
    tensorf,
    vanilla_nerf,
)
from soccernerfs_tpu_torch.ops.hash_grid import level_layout
from soccernerfs_tpu_torch.utils.device import resolve_device


# the seeded NeRF fields' density bias: a fog of ~0.3 per unit length
NERF_DENSITY_BIAS = 0.3


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


def aux_from_jax(np_aux: dict, device=None) -> dict:
    """A model's non-trainable state (the JAX ``TrainState.aux``, e.g. the
    occupancy models' ``{"occs": [R^3]}``) from numpy arrays, on ``device``
    (as ``params_from_jax``)."""
    return params_from_jax(np_aux, device)


def _seeded_mlp(rng, in_dim, hidden, layers, out_dim) -> dict:
    """Weights and biases U(-1/sqrt(fan_in), 1/sqrt(fan_in)), as the JAX
    init draws them."""
    dims = [in_dim] + [hidden] * layers + [out_dim]
    ws, bs = [], []
    for i in range(len(dims) - 1):
        bound = 1.0 / math.sqrt(dims[i])
        ws.append(rng.uniform(-bound, bound, (dims[i], dims[i + 1]))
                  .astype(np.float32))
        bs.append(rng.uniform(-bound, bound, (dims[i + 1],))
                  .astype(np.float32))
    return {"w": ws, "b": bs}


def seeded_params(cfg, seed: int, num_train_data: int = 0,
                  time_noise: float = 0.0, grid_std: float = 1e-4,
                  step: int = 0) -> dict:
    """A numpy param tree in the layout of the JAX package's
    ``init(rng, cfg, num_train_data)`` for a K-Planes, nerfacto (a
    depth-nerfacto config is one), semantic-NeRF-W, nerfplayer-nerfacto,
    instant-NGP, NeRFPlayer-NGP, NeRFPlayer, NeRFPlayer-NGP-complete,
    vanilla NeRF, mip-NeRF, TensoRF or NeuS config, drawn with numpy; MLPs
    as ``_seeded_mlp``, appearance embeddings N(0, 1).

    K-Planes: space planes U(0.1, 0.5) (proposal planes U(0.1, 0.15)), time
    planes 1 + U(-time_noise, time_noise).  The hash-grid models: hash
    tables U(-grid_std, grid_std) (the JAX init's is 1e-4).  TensoRF: its
    tables N(0, 0.1^2), as the JAX init draws them, at their resolution
    while training step ``step`` runs (past every upsampling step they
    are ``final_resolution``), the basis ``B`` as an MLP weight.  The NeRF
    fields (vanilla NeRF, mip-NeRF): the density head's bias
    ``NERF_DENSITY_BIAS``.  semantic-NeRF-W: nerfacto's tree and the
    semantic head.  NeuS: the SDF field's geometric init
    (``fields.sdf.geometric_init``), the distribution of the JAX init, so
    that the seeded field is its initial SDF.
    """
    rng = np.random.default_rng(seed)
    if isinstance(cfg, tensorf.Config):
        return _seeded_tensorf(cfg, rng, cfg.resolution_at(step))
    if isinstance(cfg, vanilla_nerf.Config):
        return {"fields": {level: _seeded_nerf_field(cfg.field_config(), rng)
                           for level in ("coarse", "fine")}}
    if isinstance(cfg, mipnerf.Config):
        return {"fields": _seeded_nerf_field(cfg.field_config(), rng)}
    if isinstance(cfg, (instant_ngp.Config, nerfplayer_ngp.Config)):
        return _seeded_ngp(cfg, rng, num_train_data, grid_std)
    if isinstance(cfg, neus.Config):
        return {"fields": _seeded_sdf_field(cfg.sdf_field, rng)}
    if isinstance(cfg, semantic_nerfw.Config):
        params = _seeded_nerfacto(cfg, rng, num_train_data, grid_std)
        params["fields"]["mlp_semantics"] = _seeded_mlp(
            rng, *semantic_nerfw.semantic_mlp_dims(cfg))
        return params
    if isinstance(cfg, nerfacto.Config):
        return _seeded_nerfacto(cfg, rng, num_train_data, grid_std)
    if isinstance(cfg, nerfplayer_nerfacto.Config):
        return _seeded_nerfplayer_nerfacto(cfg, rng, num_train_data, grid_std)
    if isinstance(cfg, (nerfplayer.Config, nerfplayer_ngp_complete.Config)):
        return _seeded_nerfplayer(cfg, rng, num_train_data, grid_std)

    def planes(feat, reso, a, b):
        out = []
        for c1, c2 in kplanes_field.plane_combinations(len(reso)):
            shape = (reso[c2], reso[c1], feat)
            if len(reso) == 4 and 3 in (c1, c2):
                g = 1.0 + rng.uniform(-time_noise, time_noise, shape)
            else:
                g = rng.uniform(a, b, shape)
            out.append(g.astype(np.float32))
        return out

    fcfg = cfg.field_config(num_train_data)
    fields = {"grids": [planes(fcfg.feat_dim, reso, 0.1, 0.5)
                        for reso in kplanes_field.scale_resolutions(fcfg)]}
    for name, dims in kplanes_field.field_mlp_dims(fcfg).items():
        fields[name] = _seeded_mlp(rng, *dims)
    if fcfg.use_appearance_embedding:
        fields["appearance_embedding"] = rng.standard_normal(
            (fcfg.num_images, fcfg.appearance_dim)).astype(np.float32)

    props = {}
    for idx, dcfg in cfg.density_field_configs():
        name = f"proposal_{idx}"
        if name not in props:
            props[name] = {
                "grids": [planes(dcfg.feature_dim, dcfg.resolution, 0.1, 0.15)],
                "sigma_net": _seeded_mlp(
                    rng, *kplanes_field.proposal_mlp_dims(dcfg)),
            }
    return {"fields": fields, "proposal_networks": props}


def _seeded_grid(gcfg, rng, grid_std: float) -> dict:
    rows = level_layout(gcfg)[0][-1]
    return {"embeddings": rng.uniform(
        -grid_std, grid_std, (rows, gcfg.row_channels)).astype(np.float32)}


def _seeded_nerfacto(cfg: nerfacto.Config, rng, num_train_data: int,
                     grid_std: float) -> dict:
    fcfg = cfg.field_config(num_train_data)
    dims = nerfacto_field.field_mlp_dims(fcfg)
    fields = {"grid": _seeded_grid(fcfg.grid, rng, grid_std),
              "mlp_base": _seeded_mlp(rng, *dims["mlp_base"])}
    if fcfg.use_appearance_embedding:
        fields["appearance_embedding"] = rng.standard_normal(
            (max(fcfg.num_images, 1), fcfg.appearance_embedding_dim)
        ).astype(np.float32)
    fields["mlp_head"] = _seeded_mlp(rng, *dims["mlp_head"])

    props = {}
    for idx, dcfg in cfg.density_field_configs():
        name = f"proposal_{idx}"
        if name not in props:
            props[name] = {
                "grid": _seeded_grid(dcfg.grid, rng, grid_std),
                "mlp": _seeded_mlp(rng, *nerfacto_field.proposal_mlp_dims(dcfg)),
            }
    return {"fields": fields, "proposal_networks": props}


def _seeded_nerfplayer_nerfacto(cfg: nerfplayer_nerfacto.Config, rng,
                                num_train_data: int, grid_std: float) -> dict:
    fcfg = cfg.field_config(num_train_data)
    dims = npn_field.field_mlp_dims(fcfg)
    fields = {"grid": _seeded_grid(fcfg.grid, rng, grid_std),
              "mlp_base_decode": _seeded_mlp(rng, *dims["mlp_base_decode"])}
    if fcfg.use_appearance_embedding:
        fields["appearance_embedding"] = rng.standard_normal(
            (max(fcfg.num_images, 1), fcfg.appearance_embedding_dim)
        ).astype(np.float32)
    fields["mlp_head"] = _seeded_mlp(rng, *dims["mlp_head"])
    return {"fields": fields,
            "proposal_networks": _seeded_proposals(cfg, rng, grid_std)}


def _seeded_proposals(cfg, rng, grid_std: float) -> dict:
    """The temporal proposal fields of a NeRFPlayer model."""
    props = {}
    for idx, dcfg in cfg.density_field_configs():
        name = f"proposal_{idx}"
        if name not in props:
            props[name] = {
                "grid": _seeded_grid(dcfg.grid, rng, grid_std),
                "mlp": _seeded_mlp(rng, *npn_field.proposal_mlp_dims(dcfg)),
            }
    return props


def _seeded_nerfplayer(cfg, rng, num_train_data: int, grid_std: float) -> dict:
    """NeRFPlayer's and NeRFPlayer-NGP-complete's tree: the decomposition
    field's three grids and five MLPs, and NeRFPlayer's proposal fields."""
    fcfg = cfg.field_config(num_train_data)
    fields = {name: _seeded_grid(grid, rng, grid_std)
              for name, grid in np_field.field_grids(fcfg).items()}
    for name, dims in np_field.field_mlp_dims(fcfg).items():
        fields[name] = _seeded_mlp(rng, *dims)
    if isinstance(cfg, nerfplayer_ngp_complete.Config):
        return {"fields": fields}
    return {"fields": fields,
            "proposal_networks": _seeded_proposals(cfg, rng, grid_std)}


def _seeded_ngp(cfg, rng, num_train_data: int, grid_std: float) -> dict:
    """instant-NGP's and NeRFPlayer-NGP's tree: {"fields": {"grid",
    "mlp_base", ["appearance_embedding"], "mlp_head"}}."""
    fcfg = cfg.field_config(num_train_data)
    field = ingp_field if isinstance(cfg, instant_ngp.Config) else npngp_field
    dims = field.field_mlp_dims(fcfg)
    fields = {"grid": _seeded_grid(fcfg.grid, rng, grid_std),
              "mlp_base": _seeded_mlp(rng, *dims["mlp_base"])}
    if fcfg.use_appearance_embedding:
        fields["appearance_embedding"] = rng.standard_normal(
            (max(fcfg.num_images, 1), fcfg.appearance_embedding_dim)
        ).astype(np.float32)
    fields["mlp_head"] = _seeded_mlp(rng, *dims["mlp_head"])
    return {"fields": fields}


def _seeded_nerf_field(fcfg, rng) -> dict:
    """A NeRF field's four MLPs (fields/vanilla_nerf.py), the density
    head's bias NERF_DENSITY_BIAS: with the init's own bias the ReLU
    density is 0 almost everywhere, and no gradient reaches the field."""
    field = {name: _seeded_mlp(rng, *dims)
             for name, dims in vnerf_field.field_mlp_dims(fcfg).items()}
    field["density_head"]["b"][-1][:] = NERF_DENSITY_BIAS
    return field


def _seeded_tensorf(cfg, rng, resolution: int) -> dict:
    """TensoRF's tree at table resolution ``resolution``."""
    r = resolution

    def tables(c):
        shapes = {"vm": {"plane_coef": (3, r, r, c), "line_coef": (3, r, c)},
                  "cp": {"line_coef": (3, r, c)},
                  "triplane": {"plane_coef": (3, r, r, c)}}[cfg.tensorf_encoding]
        return {k: (0.1 * rng.standard_normal(shape)).astype(np.float32)
                for k, shape in shapes.items()}

    encodings = {"density": tables(cfg.num_den_components),
                 "color": tables(cfg.num_color_components)}
    basis = _seeded_mlp(rng, tensorf.color_dim(cfg), 1, 0,
                        cfg.appearance_dim)["w"][0]
    return {"encodings": encodings,
            "fields": {"B": basis,
                       "mlp_head": _seeded_mlp(rng, *tensorf.head_dims(cfg))}}


def _seeded_sdf_field(fcfg, rng) -> dict:
    """The SDF field's tree, ``geometric_init`` drawn with numpy, f32."""
    def normal(shape):
        return rng.standard_normal(shape)

    def uniform(shape, lo, hi):
        return rng.uniform(lo, hi, shape)

    field = sdf_field.geometric_init(fcfg, normal, uniform, np.zeros)

    def f32(x):
        if isinstance(x, dict):
            return {k: f32(v) for k, v in x.items()}
        if isinstance(x, list):
            return [f32(v) for v in x]
        return np.asarray(x, np.float32)

    return f32(field)
