"""K-Planes field (counterpart of soccernerfs_tpu/fields/kplanes.py).

Params are plain dicts of tensors in the JAX package's layout: ``grids`` is
a list (scales) of lists (planes, k-choose-2 order XY, XZ, XT, YZ, YT, ZT)
of [H, W, F] planes, MLPs are {"w": [...], "b": [...]}.

This follows the JAX package's unsorted sampler (``interpolate_kplanes``).
Its stripe-sorted samplers exist because Mosaic cannot lower a vector
gather; a CUDA thread gathers (and atomically scatters) directly, so every
path samples in ray order through the CUDA kernels: the render path the
tables staged once by ``pack_grids_for_render``, one fused launch per scale
(``plane_kernels.kplanes_fwd_fused``), the train path the grids themselves
through the differentiable group samplers of ops/grid_sample.

Kept from the JAX package: the proposal field maps bounded positions to
[-1, 1] like the main field (the reference left them in [0, 1]), and
``times`` is optional everywhere (static scenes).
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch

from soccernerfs_tpu_torch.core.math import (
    components_from_spherical_harmonics,
    scene_contraction,
    trunc_exp,
)
from soccernerfs_tpu_torch.core.scene_box import SceneBox
from soccernerfs_tpu_torch.ops.grid_sample import (
    grid_coords,
    plane_sample_fold_group,
    plane_sample_group_bwdsort,
    quad_pack,
    stage_table,
)
from soccernerfs_tpu_torch.ops.kernels.plane_kernels import kplanes_fwd_fused
from soccernerfs_tpu_torch.ops.mlp import init_mlp, mlp_apply


def plane_combinations(in_dim: int):
    """(c1, c2) index pairs defining each plane."""
    return list(itertools.combinations(range(in_dim), 2))


def init_plane_grids(
    out_dim: int,
    reso: Sequence[int],
    a: float = 0.1,
    b: float = 0.5,
    generator: Optional[torch.Generator] = None,
    device=None,
):
    """One scale's k-choose-2 planes, each [res_c2, res_c1, out_dim]: time
    planes (touching coord 3) ones, space planes U(a, b)."""
    has_time = len(reso) == 4
    grids = []
    for c1, c2 in plane_combinations(len(reso)):
        shape = (reso[c2], reso[c1], out_dim)
        if has_time and 3 in (c1, c2):
            grids.append(torch.ones(shape, device=device))
        else:
            u = torch.rand(shape, generator=generator)
            grids.append((a + (b - a) * u).to(device))
    return grids


def _sampled_planes(pts_dim: int, n_planes: int):
    """(grid_index, (c1, c2)) pairs to sample for ``pts_dim`` coordinates.

    A 4D (time) model queried without times samples only the spatial
    planes, and their grid indices are looked up in the 4D order (XY=0,
    XZ=1, XT=2, YZ=3, ...): naive enumeration would sample XT for YZ.
    """
    grid_combs = plane_combinations(4 if n_planes == 6 else 3)
    return [
        (grid_combs.index(pair), pair) for pair in plane_combinations(pts_dim)
    ]


def pack_grids_for_render(params: dict) -> dict:
    """Stage every plane table as a bf16 copy once per parameter snapshot
    (``ops/grid_sample.stage_table``: big F = 32 tables unpacked, the rest
    quad-packed, on every device).  The copies ride the params dict under
    ``grids_packed``."""
    packed = [[stage_table(g) for g in grids] for grids in params["grids"]]
    return {**params, "grids_packed": packed}


def plane_groups(planes, grids) -> dict:
    """{(c2, width): [(grid index, c1), ...]}: the (grid index, c1, c2)
    planes of one scale grouped by their y axis and width.  A group shares
    its y fraction and costs one kernel launch."""
    groups: dict = {}
    for ci, c1, c2 in planes:
        groups.setdefault((c2, grids[ci].shape[1]), []).append((ci, c1))
    return groups


def interpolate_kplanes(
    pts: torch.Tensor,
    ms_grids,
    concat_features: bool,
    freeze_time_planes: bool = False,
    freeze_space_planes: bool = False,
    ms_packed=None,
) -> torch.Tensor:
    """Query multiscale planes: per-plane bilinear sample, Hadamard product
    over planes, concat/sum over scales.

    With ``ms_packed`` (tables staged by pack_grids_for_render; the render
    path, no gradient) each scale is one fused launch
    (``kplanes_fwd_fused``) that multiplies the planes in the JAX
    package's order (``_sampled_planes``) and writes the scale's features
    into its column slice of the concatenated output; a plane's layout
    and shape come from its staged table and its grid.  Without it the
    differentiable group samplers read the grids, the planes of one scale
    grouped by their y axis and width (one kernel launch per group, as the
    JAX package's sorted path groups them): narrow (F = 8) planes whose
    widths divide by 4 quad-packed (plane_sample_group_bwdsort, the JAX
    condition of its proposal-field path), the rest through
    plane_sample_fold_group.  With grad disabled that product runs in
    place into a running per-scale tensor; with grad enabled out of
    place, since autograd keeps every factor for the product's backward.

    Positions carry no gradient here (PDF bins are detached and the camera
    optimizer is not ported): the group samplers return none for their
    coordinates, so the function refuses ``pts`` that require grad rather
    than give silent zeros.

    Args:
        pts: [M, 3] or [M, 4] normalized coordinates in [-1, 1].
        ms_grids: list (scales) of lists (planes) of [H, W, F] tensors.
        freeze_time_planes: skip the time planes; freeze_space_planes:
            detach the space planes.
    Returns:
        [M, F * num_scales] if concat else [M, F].
    """
    if pts.requires_grad:
        raise ValueError("plane coordinates that require grad are not "
                         "supported: the plane samplers give them none")
    dim = pts.shape[-1]
    has_time = dim == 4
    feat = ms_grids[0][0].shape[-1]
    planes = [
        (ci, c1, c2)
        for ci, (c1, c2) in _sampled_planes(dim, len(ms_grids[0]))
        if not (freeze_time_planes and has_time and 3 in (c1, c2))
    ]
    if ms_packed is not None:
        return _interpolate_staged(pts, ms_grids, ms_packed, planes,
                                   concat_features)
    narrow = feat == 8 and all(g.shape[1] % 4 == 0 for g in ms_grids[0])
    inplace = not torch.is_grad_enabled()
    per_scale = []
    for grids in ms_grids:
        acc = None
        for (c2, w), members in plane_groups(planes, grids).items():
            h = grids[members[0][0]].shape[0]
            yc, ty = grid_coords(pts[:, c2], h)
            rowids, txs = [], []
            for _ci, c1 in members:
                xc, tx = grid_coords(pts[:, c1], w)
                rowids.append(yc * w + xc)
                txs.append(tx)
            sel = [
                grids[ci].detach()
                if freeze_space_planes and not (has_time and 3 in (c1, c2))
                else grids[ci]
                for ci, c1 in members
            ]
            if narrow:
                feats = plane_sample_group_bwdsort(
                    [quad_pack(g) for g in sel], rowids, txs, ty)
            else:
                feats = plane_sample_fold_group(sel, rowids, txs, ty)
            for f in feats:
                if acc is None:
                    acc = f
                elif inplace:
                    acc.mul_(f)
                else:
                    acc = acc * f
        per_scale.append(acc)
    if concat_features:
        return torch.cat(per_scale, dim=-1)
    total = per_scale[0]
    for p in per_scale[1:]:
        total = total.add_(p) if inplace else total + p
    return total


@torch.no_grad()
def _interpolate_staged(pts, ms_grids, ms_packed, planes, concat_features):
    """interpolate_kplanes over staged tables: one kplanes_fwd_fused launch
    per scale, into the scale's column slice of the [M, S*F] output (or
    an [M, F] output per scale, summed, without concatenation)."""
    pts = pts.contiguous()
    m, n_scales = pts.shape[0], len(ms_grids)
    feat = ms_grids[0][0].shape[-1]
    width = n_scales * feat if concat_features else feat
    out = torch.empty((m, width), dtype=torch.float32, device=pts.device)
    for s, grids in enumerate(ms_grids):
        descs = [(c1, c2, *grids[ci].shape[:2]) for ci, c1, c2 in planes]
        tables = [ms_packed[s][ci] for ci, _c1, _c2 in planes]
        if concat_features:
            kplanes_fwd_fused(pts, tables, descs,
                              out[:, s * feat:(s + 1) * feat])
        elif s == 0:
            kplanes_fwd_fused(pts, tables, descs, out)
        else:
            out.add_(kplanes_fwd_fused(pts, tables, descs,
                                       torch.empty_like(out)))
    return out


@dataclass(frozen=True)
class KPlanesFieldConfig:
    """Static config for the main K-Planes field."""

    spacetime_resolution: Tuple[int, ...] = (256, 256, 256, 150)
    feat_dim: int = 16
    multiscale_res: Tuple[int, ...] = (1,)
    concat_features_across_scales: bool = False
    linear_decoder: bool = True
    linear_decoder_layers: int = 1
    use_appearance_embedding: bool = False
    appearance_dim: int = 27
    num_images: int = 0
    disable_viewing_dependent: bool = False
    sigma_net_layers: int = 1
    sigma_net_hidden_dim: int = 64
    rgb_net_layers: int = 2
    rgb_net_hidden_dim: int = 64
    bounded: bool = True
    freeze_time_planes: bool = False
    freeze_space_planes: bool = False
    geo_feat_dim: int = 15
    sh_degree: int = 4

    @property
    def has_time_planes(self) -> bool:
        return len(self.spacetime_resolution) == 4

    @property
    def feature_dim(self) -> int:
        if self.concat_features_across_scales:
            return self.feat_dim * len(self.multiscale_res)
        return self.feat_dim

    @property
    def appearance_embedding_dim(self) -> int:
        return self.appearance_dim if self.use_appearance_embedding else 0


def scale_resolutions(cfg: KPlanesFieldConfig):
    """Per scale, the plane resolutions (x, y, z[, t]): space scaled by the
    scale's multiplier, time kept."""
    out = []
    for res_mult in cfg.multiscale_res:
        resolution = [r * res_mult for r in cfg.spacetime_resolution[:3]]
        if cfg.has_time_planes:
            resolution.append(cfg.spacetime_resolution[3])
        out.append(resolution)
    return out


def field_mlp_dims(cfg: KPlanesFieldConfig) -> dict:
    """{name: (in_dim, hidden_dim, num_hidden_layers, out_dim)} of the main
    field's MLPs."""
    if cfg.linear_decoder:
        return {
            "color_basis": (3 + cfg.appearance_embedding_dim, 128,
                            cfg.linear_decoder_layers, 3 * cfg.feature_dim),
            "sigma_net": (cfg.feature_dim, 128, 0, 1),
        }
    in_dim_color = cfg.geo_feat_dim + cfg.appearance_embedding_dim
    if not cfg.disable_viewing_dependent:
        in_dim_color += cfg.sh_degree**2
    return {
        "sigma_net": (cfg.feature_dim, cfg.sigma_net_hidden_dim,
                      cfg.sigma_net_layers, cfg.geo_feat_dim + 1),
        "color_net": (in_dim_color, cfg.rgb_net_hidden_dim,
                      cfg.rgb_net_layers, 3),
    }


def init_kplanes_field(
    cfg: KPlanesFieldConfig,
    generator: Optional[torch.Generator] = None,
    device=None,
) -> dict:
    """Param dict of the main field, in the JAX package's layout."""
    params: dict = {
        "grids": [init_plane_grids(cfg.feat_dim, reso, generator=generator,
                                   device=device)
                  for reso in scale_resolutions(cfg)],
    }
    for name, dims in field_mlp_dims(cfg).items():
        params[name] = init_mlp(*dims, generator=generator, device=device)
    if cfg.use_appearance_embedding:
        params["appearance_embedding"] = torch.randn(
            (cfg.num_images, cfg.appearance_dim), generator=generator
        ).to(device)
    return params


def normalize_positions(
    positions: torch.Tensor, aabb: torch.Tensor, bounded: bool
) -> torch.Tensor:
    """World positions -> [-1, 1] plane coordinates: aabb-normalise then
    affine (bounded), or L_inf contraction to [-2, 2] halved."""
    if bounded:
        return SceneBox.get_normalized_positions(positions, aabb) * 2.0 - 1.0
    return scene_contraction(positions, order=math.inf) / 2.0


def _spacetime_coords(cfg_has_time, positions, times):
    if cfg_has_time and times is not None:
        t = times * 2.0 - 1.0  # [0, 1] -> [-1, 1]
        return torch.cat([positions, t[..., None]], dim=-1)
    return positions


def kplanes_density(
    cfg: KPlanesFieldConfig,
    params: dict,
    aabb: torch.Tensor,
    positions: torch.Tensor,
    times: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Density [M] and geometric features [M, geo_feat_dim or
    feature_dim] at world positions [M, 3] (times [M] in [0, 1] or None).
    Samples the staged tables when ``params`` carries them."""
    pts = normalize_positions(positions, aabb, cfg.bounded)
    pts = _spacetime_coords(cfg.has_time_planes, pts, times)
    features = interpolate_kplanes(
        pts,
        params["grids"],
        concat_features=cfg.concat_features_across_scales,
        freeze_time_planes=cfg.freeze_time_planes,
        freeze_space_planes=cfg.freeze_space_planes,
        ms_packed=params.get("grids_packed"),
    )
    if cfg.linear_decoder:
        density_before = mlp_apply(
            params["sigma_net"], features, activation="none",
            output_activation="none",
        )[..., 0]
    else:
        out = mlp_apply(
            params["sigma_net"], features, activation="relu",
            output_activation="none",
        )
        features, density_before = out[..., : cfg.geo_feat_dim], out[..., -1]
    return trunc_exp(density_before), features


def kplanes_rgb(
    cfg: KPlanesFieldConfig,
    params: dict,
    features: torch.Tensor,
    directions: torch.Tensor,
    camera_indices: Optional[torch.Tensor] = None,
    train: bool = False,
) -> torch.Tensor:
    """Color [M, 3] in [0, 1] from features [M, D] and unit view
    directions [M, 3]; appearance embeddings use their mean outside
    training."""
    if cfg.linear_decoder or cfg.disable_viewing_dependent:
        color_features = [features]
    else:
        encoded_dirs = components_from_spherical_harmonics(cfg.sh_degree,
                                                           directions)
        color_features = [encoded_dirs, features]

    dirs_input = directions
    if cfg.use_appearance_embedding:
        emb = params["appearance_embedding"]
        if train:
            assert camera_indices is not None
            embedded = emb[camera_indices.long()]
        else:
            embedded = emb.mean(dim=0).expand(directions.shape[0], -1)
        if cfg.linear_decoder:
            dirs_input = torch.cat([dirs_input, embedded], dim=-1)
        else:
            color_features.append(embedded)

    color_features = torch.cat(color_features, dim=-1)

    if cfg.linear_decoder:
        basis = mlp_apply(
            params["color_basis"], dirs_input, activation="relu",
            output_activation="none",
        )
        basis = basis.reshape(*color_features.shape[:-1], 3, cfg.feature_dim)
        rgb = torch.sum(color_features[..., None, :] * basis, dim=-1)
        return torch.sigmoid(rgb)
    return mlp_apply(
        params["color_net"], color_features, activation="relu",
        output_activation="sigmoid",
    )


def kplanes_field_forward(
    cfg: KPlanesFieldConfig,
    params: dict,
    aabb: torch.Tensor,
    positions: torch.Tensor,
    directions: torch.Tensor,
    times: Optional[torch.Tensor] = None,
    camera_indices: Optional[torch.Tensor] = None,
    train: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(density [M], rgb [M, 3]) = kplanes_density + kplanes_rgb."""
    density, features = kplanes_density(cfg, params, aabb, positions, times)
    return density, kplanes_rgb(
        cfg, params, features, directions, camera_indices, train=train
    )


# ---------------------------------------------------------------------------
# Proposal density field
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class KPlanesDensityFieldConfig:
    """Static config for one proposal density field."""

    resolution: Tuple[int, ...] = (128, 128, 128)
    feature_dim: int = 8
    linear_decoder: bool = True
    bounded: bool = True
    freeze_time_planes: bool = False
    freeze_space_planes: bool = False

    @property
    def has_time_planes(self) -> bool:
        return len(self.resolution) == 4


def proposal_mlp_dims(cfg: KPlanesDensityFieldConfig):
    """(in_dim, hidden_dim, num_hidden_layers, out_dim) of the sigma net."""
    return (cfg.feature_dim, 64, 1, 1)


def init_kplanes_density_field(
    cfg: KPlanesDensityFieldConfig,
    generator: Optional[torch.Generator] = None,
    device=None,
) -> dict:
    """Single-scale planes (space U(0.1, 0.15)) plus a 64-wide
    1-hidden-layer sigma net."""
    return {
        "grids": [init_plane_grids(cfg.feature_dim, cfg.resolution, a=0.1,
                                   b=0.15, generator=generator, device=device)],
        "sigma_net": init_mlp(*proposal_mlp_dims(cfg), generator=generator,
                              device=device),
    }


def kplanes_density_field_density(
    cfg: KPlanesDensityFieldConfig,
    params: dict,
    aabb: torch.Tensor,
    positions: torch.Tensor,
    times: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Density [M] at positions [M, 3] (times [M] or None), for proposal
    sampling."""
    pts = normalize_positions(positions, aabb, cfg.bounded)
    pts = _spacetime_coords(cfg.has_time_planes, pts, times)
    features = interpolate_kplanes(
        pts,
        params["grids"],
        concat_features=False,
        freeze_time_planes=cfg.freeze_time_planes,
        freeze_space_planes=cfg.freeze_space_planes,
        ms_packed=params.get("grids_packed"),
    )
    activation = "none" if cfg.linear_decoder else "relu"
    density_before = mlp_apply(
        params["sigma_net"], features, activation=activation,
        output_activation="none",
    )[..., 0]
    return trunc_exp(density_before)
