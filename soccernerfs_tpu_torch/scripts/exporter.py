"""snt-export: a trained run to point clouds, meshes and cameras
(counterpart of soccernerfs_tpu/scripts/exporter.py, with its subcommands,
arguments and defaults).

  pointcloud      render the eval cameras' rgb and depth, backproject to a
                  coloured point cloud (PLY)
  cameras         the train and eval cameras' intrinsics and extrinsics
                  (JSON)
  tsdf            depth-map TSDF fusion into a voxel grid, meshed by
                  marching tetrahedra (PLY)
  marching-cubes  the density field's isosurface on a grid in the scene box
                  (PLY)
  poisson         Poisson surface reconstruction from the rendered depth
                  maps' oriented points, an FFT solve (ops/poisson.py) (PLY)

    python -m soccernerfs_tpu_torch.scripts.exporter pointcloud \
        --load-config <run>/config.yml --output-dir exports/

The renders and the density queries run on the device (CUDA unless the
caller names another); each image and each block of the volume comes to
the host once, and the fusion, the solve and the meshing run there in
numpy.
"""
from __future__ import annotations

import argparse
import json
import struct
from pathlib import Path

import numpy as np
import torch

from soccernerfs_tpu_torch.utils.device import full_f32


def write_ply(path: Path, points: np.ndarray, colors=None, faces=None) -> None:
    """Binary little-endian PLY: points [N, 3] as f32, colours [N, 3] in
    [0, 1] as uchar, faces [F, 3] as lists of int32."""
    path.parent.mkdir(parents=True, exist_ok=True)
    n = points.shape[0]
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    header += [f"property float {c}" for c in "xyz"]
    if colors is not None:
        header += [f"property uchar {c}" for c in ("red", "green", "blue")]
    if faces is not None:
        header += [f"element face {faces.shape[0]}",
                   "property list uchar int vertex_indices"]
    header.append("end_header")
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        if colors is not None:
            c8 = (np.clip(colors, 0, 1) * 255).astype(np.uint8)
            for p, c in zip(points.astype("<f4"), c8):
                f.write(p.tobytes() + c.tobytes())
        else:
            f.write(points.astype("<f4").tobytes())
        if faces is not None:
            for face in faces.astype("<i4"):
                f.write(struct.pack("<B", 3) + face.tobytes())
    print(f"wrote {path} ({n} vertices"
          + (f", {faces.shape[0]} faces)" if faces is not None else ")"))


def _setup(args, device):
    from soccernerfs_tpu_torch.utils.eval_utils import eval_setup

    return eval_setup(args.load_config, "inference", device=device)[1]


def _image_rays(cams, idx: int, h: int, w: int):
    """One camera's ray origins and directions, [h, w, 3] each, on the
    host."""
    from soccernerfs_tpu_torch.core.cameras import generate_image_rays

    rays = generate_image_rays(cams, idx)
    return (rays.origins.cpu().numpy().reshape(h, w, 3),
            rays.directions.cpu().numpy().reshape(h, w, 3))


def _backproject(trainer, num_cameras: int, downsample: int = 4):
    """Render eval cameras; their depth backprojected to world points with
    the rendered colours, every ``downsample``-th pixel of accumulation
    above 0.5."""
    cams = trainer.eval_cameras
    pts, cols = [], []
    for idx in range(min(num_cameras, cams.num_cameras)):
        outputs = trainer.render_camera(cams, idx)
        h, w = outputs["rgb"].shape[:2]
        origins, dirs = _image_rays(cams, idx, h, w)
        sl = (slice(None, None, downsample), slice(None, None, downsample))
        keep = (outputs["accumulation"] > 0.5)[sl]
        pts.append((origins + dirs * outputs["depth"][..., None])[sl][keep])
        cols.append(outputs["rgb"][sl][keep])
    return np.concatenate(pts), np.concatenate(cols)


def cmd_pointcloud(args, device=None) -> Path:
    trainer = _setup(args, device)
    pts, cols = _backproject(trainer, args.num_cameras, args.downsample)
    if args.num_points and pts.shape[0] > args.num_points:
        sel = np.random.default_rng(0).choice(pts.shape[0], args.num_points,
                                              replace=False)
        pts, cols = pts[sel], cols[sel]
    path = args.output_dir / "point_cloud.ply"
    write_ply(path, pts, cols)
    return path


def cmd_cameras(args, device=None) -> Path:
    trainer = _setup(args, device)
    out = {}
    for split, cams in (("train", trainer.train_cameras),
                        ("eval", trainer.eval_cameras)):
        host = {f: getattr(cams, f).cpu().numpy()
                for f in ("camera_to_worlds", "fx", "fy", "cx", "cy", "width",
                          "height")}
        times = None if cams.times is None else cams.times.cpu().numpy()
        out[split] = [{
            "camera_to_world": host["camera_to_worlds"][i].tolist(),
            "fx": float(host["fx"][i]),
            "fy": float(host["fy"][i]),
            "cx": float(host["cx"][i]),
            "cy": float(host["cy"][i]),
            "width": int(host["width"][i]),
            "height": int(host["height"][i]),
            "time": None if times is None else float(times[i]),
        } for i in range(cams.num_cameras)]
    args.output_dir.mkdir(parents=True, exist_ok=True)
    path = args.output_dir / "cameras.json"
    path.write_text(json.dumps(out, indent=2))
    print(f"wrote {path}")
    return path


def density_volume(trainer, resolution: int, time):
    """The model's density on a ``resolution``^3 grid spanning the scene
    box (the grid's points in f32, as the JAX exporter queries them), in
    blocks of 2^16 points: the model's ``density_at(cfg, params, aabb,
    positions, time)`` where it has one, else K-Planes' field density
    where the params hold plane grids (the staged render tables: the
    forward plane kernels); another model exits.  Returns (volume
    [R, R, R] f32, aabb [2, 3])."""
    from soccernerfs_tpu_torch.fields import kplanes as fk

    model, cfg = trainer.model, trainer.model_cfg
    aabb = trainer.aabb.cpu().numpy()
    g = [np.linspace(aabb[0][d], aabb[1][d], resolution) for d in range(3)]
    X, Y, Z = np.meshgrid(*g, indexing="ij")
    pts = np.stack([X, Y, Z], axis=-1).reshape(-1, 3).astype(np.float32)
    params = trainer.state.params
    if not hasattr(model, "density_at"):
        if "grids" not in params.get("fields", {}):
            raise SystemExit(
                "density export not supported for this model; "
                "expose density_at(cfg, params, aabb, positions, time)")
        if hasattr(model, "prepare_render_params"):
            params = model.prepare_render_params(cfg, params)
    dev = trainer.aabb.device
    vol = np.zeros(pts.shape[0], np.float32)
    chunk = 1 << 16
    with torch.no_grad(), full_f32():
        for i in range(0, pts.shape[0], chunk):
            block = torch.from_numpy(pts[i:i + chunk]).to(dev)
            if hasattr(model, "density_at"):
                d = model.density_at(cfg, params, trainer.aabb, block, time)
            else:
                times = (None if time is None
                         else torch.full((block.shape[0],), time, device=dev))
                d, _ = fk.kplanes_density(cfg.field_config(), params["fields"],
                                          trainer.aabb, block, times)
            vol[i:i + chunk] = d.cpu().numpy()
    return vol.reshape(resolution, resolution, resolution), aabb


def cmd_marching_cubes(args, device=None) -> Path:
    from soccernerfs_tpu_torch.ops.marching import marching_tetrahedra

    trainer = _setup(args, device)
    vol, aabb = density_volume(trainer, args.resolution, args.time)
    spacing = (aabb[1] - aabb[0]) / (args.resolution - 1)
    verts, faces = marching_tetrahedra(vol, args.iso_level, aabb[0], spacing)
    path = args.output_dir / "mesh.ply"
    write_ply(path, verts, faces=faces)
    return path


def cmd_tsdf(args, device=None) -> Path:
    """Depth-map TSDF fusion: every voxel projected into each eval camera
    and updated with its truncated signed distance to the rendered depth,
    then meshed at 0."""
    from soccernerfs_tpu_torch.ops.marching import marching_tetrahedra

    trainer = _setup(args, device)
    aabb = trainer.aabb.cpu().numpy()
    res = args.resolution
    g = [np.linspace(aabb[0][d], aabb[1][d], res) for d in range(3)]
    X, Y, Z = np.meshgrid(*g, indexing="ij")
    voxels = np.stack([X, Y, Z], -1).reshape(-1, 3)
    tsdf = np.full(voxels.shape[0], 1.0, np.float32)
    weight = np.zeros(voxels.shape[0], np.float32)
    trunc = args.truncation * float((aabb[1] - aabb[0]).max())

    cams = trainer.eval_cameras
    c2ws = cams.camera_to_worlds.cpu().numpy()
    intrinsics = {f: getattr(cams, f).cpu().numpy() for f in ("fx", "fy", "cx", "cy")}
    for idx in range(min(args.num_cameras, cams.num_cameras)):
        outputs = trainer.render_camera(cams, idx)
        h, w = outputs["depth"].shape[:2]
        R, t = c2ws[idx][:3, :3], c2ws[idx][:3, 3]
        local = (voxels - t) @ R  # world -> camera (R orthonormal)
        zs = -local[:, 2]
        valid = zs > 1e-6
        fx, fy = float(intrinsics["fx"][idx]), float(intrinsics["fy"][idx])
        cx, cy = float(intrinsics["cx"][idx]), float(intrinsics["cy"][idx])
        u = (local[:, 0] / np.where(valid, zs, 1.0)) * fx + cx
        v = (-local[:, 1] / np.where(valid, zs, 1.0)) * fy + cy
        inside = valid & (u >= 0) & (u < w) & (v >= 0) & (v < h)
        ui = np.clip(u.astype(int), 0, w - 1)
        vi = np.clip(v.astype(int), 0, h - 1)
        sdf = (outputs["depth"][vi, ui] - zs) / trunc
        upd = inside & (sdf > -1.0)
        sdf = np.clip(sdf, -1.0, 1.0)
        new_w = weight + upd
        tsdf = np.where(upd, (tsdf * weight + sdf) / np.maximum(new_w, 1), tsdf)
        weight = new_w

    vol = tsdf.reshape(res, res, res)
    spacing = (aabb[1] - aabb[0]) / (res - 1)
    verts, faces = marching_tetrahedra(-vol, 0.0, aabb[0], spacing)
    path = args.output_dir / "tsdf_mesh.ply"
    write_ply(path, verts, faces=faces)
    return path


def cmd_poisson(args, device=None) -> Path:
    """A Poisson mesh of the rendered depth maps' points, each with the
    normal of its structured point map (image-space tangents, facing the
    camera)."""
    from soccernerfs_tpu_torch.ops.poisson import depth_map_normals, poisson_reconstruct

    trainer = _setup(args, device)
    cams = trainer.eval_cameras
    pts, nrms = [], []
    for idx in range(min(args.num_cameras, cams.num_cameras)):
        outputs = trainer.render_camera(cams, idx)
        h, w = outputs["rgb"].shape[:2]
        origins, dirs = _image_rays(cams, idx, h, w)
        pmap = origins + dirs * outputs["depth"][..., None]
        normals = depth_map_normals(pmap, origins)
        sl = (slice(None, None, args.downsample),) * 2
        keep = (outputs["accumulation"] > 0.5)[sl]
        pts.append(pmap[sl][keep])
        nrms.append(normals[sl][keep])
    pts = np.concatenate(pts) if pts else np.zeros((0, 3), np.float32)
    if pts.shape[0] == 0:
        raise SystemExit(
            "no surface points above accumulation 0.5 — train longer or "
            "render more cameras before exporting a poisson mesh")
    nrms = np.concatenate(nrms)
    if args.num_points and pts.shape[0] > args.num_points:
        sel = np.random.default_rng(0).choice(pts.shape[0], args.num_points,
                                              replace=False)
        pts, nrms = pts[sel], nrms[sel]
    aabb = np.stack([pts.min(0), pts.max(0)])
    verts, faces = poisson_reconstruct(pts, nrms, aabb, resolution=args.resolution)
    path = args.output_dir / "poisson_mesh.ply"
    write_ply(path, verts, faces=faces)
    return path


def build_parser() -> argparse.ArgumentParser:
    """The JAX exporter's command line: five subcommands, their arguments
    and defaults."""
    parser = argparse.ArgumentParser("snt-export")
    sub = parser.add_subparsers(dest="cmd", required=True)

    def common(p):
        p.add_argument("--load-config", type=Path, required=True)
        p.add_argument("--output-dir", type=Path, default=Path("exports"))

    p = sub.add_parser("pointcloud")
    common(p)
    p.add_argument("--num-points", type=int, default=1_000_000)
    p.add_argument("--num-cameras", type=int, default=10)
    p.add_argument("--downsample", type=int, default=4)
    p.set_defaults(fn=cmd_pointcloud)

    p = sub.add_parser("cameras")
    common(p)
    p.set_defaults(fn=cmd_cameras)

    p = sub.add_parser("marching-cubes")
    common(p)
    p.add_argument("--resolution", type=int, default=128)
    p.add_argument("--iso-level", type=float, default=5.0)
    p.add_argument("--time", type=float, default=None)
    p.set_defaults(fn=cmd_marching_cubes)

    p = sub.add_parser("tsdf")
    common(p)
    p.add_argument("--resolution", type=int, default=128)
    p.add_argument("--num-cameras", type=int, default=10)
    p.add_argument("--truncation", type=float, default=0.05)
    p.set_defaults(fn=cmd_tsdf)

    p = sub.add_parser("poisson")
    common(p)
    p.add_argument("--resolution", type=int, default=192)
    p.add_argument("--num-points", type=int, default=1_000_000)
    p.add_argument("--num-cameras", type=int, default=10)
    p.add_argument("--downsample", type=int, default=2)
    p.set_defaults(fn=cmd_poisson)
    return parser


def main(argv=None, device=None) -> Path:
    """Run the subcommand of ``argv`` (``sys.argv[1:]`` by default); returns
    the file written.  ``device``: default CUDA; raises when CUDA is absent
    and the caller did not ask for another device."""
    args = build_parser().parse_args(argv)
    return args.fn(args, device)


if __name__ == "__main__":
    main()
