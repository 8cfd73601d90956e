"""The port's exporter (soccernerfs_tpu_torch/scripts/exporter.py,
ops/marching.py, ops/poisson.py) against the JAX package on the CPU:
marching tetrahedra and the Poisson reconstruction of a sphere (the same
vertices and faces), the FFT solve and its pieces, the depth-map normals,
the PLY bytes, the command line; then every subcommand on a tiny K-Planes
snapshot trained through the port's snt-train.  The JAX exporter cannot
read the port's config.yml, so the parts are held separately: the cameras
JSON against the JAX parser's cameras of the same fixture, the
marching-cubes volume against the port's K-Planes density and the JAX
package's on the same grid and params, its mesh and PLY against JAX's
marching tetrahedra and PLY writer of that volume.
"""
import contextlib
import dataclasses
import io
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from soccernerfs_tpu.data.dataparsers.blender import BlenderDataParserConfig as JBlender
from soccernerfs_tpu.fields import kplanes as jfk
from soccernerfs_tpu.models import kplanes as jkm
from soccernerfs_tpu.ops import marching as jmarch
from soccernerfs_tpu.ops import poisson as jpoisson
from soccernerfs_tpu.scripts import exporter as jexp
from soccernerfs_tpu_torch.data.fixtures import make_blender_fixture
from soccernerfs_tpu_torch.fields import kplanes as tfk
from soccernerfs_tpu_torch.ops import marching as tmarch
from soccernerfs_tpu_torch.ops import poisson as tpoisson
from soccernerfs_tpu_torch.scripts import exporter as texp
from soccernerfs_tpu_torch.scripts import train as train_script
from soccernerfs_tpu_torch.utils.eval_utils import eval_setup


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch CPU thread while this file runs (the suite runs in
    parallel worker processes, whose default thread pools oversubscribe
    the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


CPU = "cpu"


def _sphere_volume(res=20, radius=0.6):
    g = np.linspace(-1, 1, res)
    X, Y, Z = np.meshgrid(g, g, g, indexing="ij")
    return (np.sqrt(X**2 + Y**2 + Z**2) - radius).astype(np.float32)


def _sphere_points(n=600, seed=0):
    rng = np.random.default_rng(seed)
    normals = rng.normal(size=(n, 3)).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    return (0.5 * normals + 0.01 * rng.normal(size=(n, 3))).astype(np.float32), normals


# ---------------------------------------------------------------------------
# the host numerics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("level", [0.0, 0.1])
def test_marching_tetrahedra_matches_jax(level):
    """The same numpy: vertices and faces equal to the JAX package's."""
    vol = _sphere_volume()
    origin, spacing = np.full(3, -1.0), np.full(3, 2.0 / 19)
    jv, jf = jmarch.marching_tetrahedra(vol, level, origin, spacing)
    tv, tf = tmarch.marching_tetrahedra(vol, level, origin, spacing)
    assert tf.shape[0] > 100
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tf, jf)
    r = np.linalg.norm(tv, axis=-1)
    assert abs(r.mean() - (0.6 + level)) < 0.02


def test_marching_tetrahedra_of_a_flat_volume_is_empty():
    v, f = tmarch.marching_tetrahedra(np.zeros((4, 4, 4), np.float32), 0.5,
                                      np.zeros(3), np.ones(3))
    assert v.shape == (0, 3) and f.shape == (0, 3)


def test_poisson_reconstruct_matches_jax():
    """An oriented sphere of radius 0.5: the mesh equal to the JAX
    package's, and a closed surface near that radius."""
    pts, nrms = _sphere_points()
    aabb = np.stack([pts.min(0), pts.max(0)])
    jv, jf = jpoisson.poisson_reconstruct(pts, nrms, aabb, resolution=24)
    tv, tf = tpoisson.poisson_reconstruct(pts, nrms, aabb, resolution=24)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tf, jf)
    assert tf.shape[0] > 100
    assert abs(np.linalg.norm(tv, axis=-1).mean() - 0.5) < 0.05


def test_poisson_pieces_match_jax():
    """The splat, the trilinear sample and the FFT solve: equal."""
    pts, nrms = _sphere_points(200, seed=1)
    grid_pts = (pts + 0.6) / 1.2 * 15
    np.testing.assert_array_equal(tpoisson.splat_vector_field(grid_pts, nrms, 16),
                                  jpoisson.splat_vector_field(grid_pts, nrms, 16))
    vol = np.random.default_rng(2).normal(size=(16, 16, 16)).astype(np.float32)
    np.testing.assert_array_equal(tpoisson.sample_trilinear(vol, grid_pts),
                                  jpoisson.sample_trilinear(vol, grid_pts))
    np.testing.assert_array_equal(tpoisson.solve_poisson_fft(vol, eps=1e-3),
                                  jpoisson.solve_poisson_fft(vol, eps=1e-3))


def test_depth_map_normals_match_jax():
    """A tilted plane seen from a camera: equal to JAX's, unit length, and
    facing the camera."""
    ys, xs = np.meshgrid(np.linspace(-1, 1, 9), np.linspace(-1, 1, 11),
                         indexing="ij")
    pmap = np.stack([xs, ys, -3.0 + 0.3 * xs], -1).astype(np.float32)
    cam = np.zeros(3, np.float32)
    got = tpoisson.depth_map_normals(pmap, cam)
    np.testing.assert_array_equal(got, jpoisson.depth_map_normals(pmap, cam))
    assert np.allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)
    assert (np.sum(got * (cam - pmap), -1) > 0).all()


@pytest.mark.parametrize("kind", ["points", "colors", "faces"])
def test_write_ply_is_byte_equal(tmp_path, kind, capsys):
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(50, 3))
    kw = {"colors": {"colors": rng.uniform(-0.1, 1.1, (50, 3))},
          "faces": {"faces": rng.integers(0, 50, (20, 3))},
          "points": {}}[kind]
    jexp.write_ply(tmp_path / "j.ply", pts, **kw)
    texp.write_ply(tmp_path / "t" / "t.ply", pts, **kw)
    assert (tmp_path / "t" / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    out = capsys.readouterr().out.splitlines()
    assert out[0].split(" (")[1] == out[1].split(" (")[1]


def _help(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), pytest.raises(SystemExit) as e:
        main(argv)
    assert e.value.code == 0
    return buf.getvalue()


@pytest.mark.parametrize("cmd", [None, "pointcloud", "cameras", "marching-cubes",
                                 "tsdf", "poisson"])
def test_command_line_is_the_jax_exporters(cmd):
    """Each subcommand's arguments and defaults: --help prints what the JAX
    exporter's prints; parsed defaults are equal."""
    argv = ["--help"] if cmd is None else [cmd, "--help"]
    assert _help(texp.main, argv) == _help(jexp.main, argv)
    if cmd is not None:
        args = texp.build_parser().parse_args([cmd, "--load-config", "c.yml"])
        assert args.cmd == cmd and str(args.output_dir) == "exports"


# ---------------------------------------------------------------------------
# the subcommands on a trained snapshot
# ---------------------------------------------------------------------------

FLAGS = [
    "--max-num-iterations", "2", "--steps-per-save", "2",
    "--pipeline.model.spacetime-resolution", "8", "8", "8",
    "--pipeline.model.multiscale-res", "1", "2",
    "--pipeline.model.feature-dim", "4",
    "--pipeline.model.num-proposal-samples-per-ray", "8", "6",
    "--pipeline.model.num-nerf-samples-per-ray", "4",
    "--pipeline.model.sigma-net-hidden-dim", "16",
    "--pipeline.model.rgb-net-hidden-dim", "16",
    "--pipeline.datamanager.train-num-rays-per-batch", "64",
]


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    """k-planes-static trained 2 steps through the port's snt-train on the
    blender fixture; its config.yml."""
    root = tmp_path_factory.mktemp("export")
    data = make_blender_fixture(root / "data")
    trainer = train_script.main(
        ["k-planes-static", *FLAGS, "--output-dir", str(root / "out"),
         "blender-data", "--data", str(data)], device=CPU)
    return root, data, trainer.base_dir / "config.yml"


def _export(config, cmd, out, *extra):
    return texp.main([cmd, "--load-config", str(config), "--output-dir", str(out),
                      *extra], device=CPU)


def _ply_counts(path):
    head = path.read_bytes().split(b"end_header\n")[0].decode().splitlines()
    counts = {ln.split()[1]: int(ln.split()[2]) for ln in head
              if ln.startswith("element")}
    return head, counts


def test_cameras_json_holds_the_jax_parsers_cameras(snapshot, tmp_path):
    """cameras.json: the train and eval ("test" split, as inference reads
    it) cameras of the JAX Blender parser on the same fixture, value for
    value."""
    _root, data, config = snapshot
    path = _export(config, "cameras", tmp_path)
    got = json.loads(path.read_text())
    parser = JBlender(data=data).setup()
    for split, jsplit in (("train", "train"), ("eval", "test")):
        cams = parser.get_dataparser_outputs(jsplit).cameras
        assert len(got[split]) == cams.num_cameras > 0
        for i, entry in enumerate(got[split]):
            assert entry["camera_to_world"] == np.asarray(
                cams.camera_to_worlds[i]).tolist()
            for f in ("fx", "fy", "cx", "cy"):
                assert entry[f] == float(np.asarray(getattr(cams, f))[i]), f
            for f in ("width", "height"):
                assert entry[f] == int(np.asarray(getattr(cams, f))[i]), f
            assert entry["time"] is None


@pytest.fixture(scope="module")
def volume(snapshot):
    _root, _data, config = snapshot
    _, trainer, _ = eval_setup(config, "inference", device=CPU)
    vol, aabb = texp.density_volume(trainer, 12, None)
    return trainer, vol, aabb


def test_marching_cubes_volume_is_the_kplanes_density(volume):
    """The volume: the port's K-Planes density at the grid's points (its
    render tables, bf16 as the JAX forward reads them), and the JAX
    package's K-Planes density of the same params on the same grid within
    1e-3 of its largest value (bf16 tables on both sides; f32 sums in
    another order, and the bf16 MLP operands flip a rounding now and
    then)."""
    trainer, vol, aabb = volume
    cfg = trainer.model_cfg
    g = [np.linspace(aabb[0][d], aabb[1][d], 12) for d in range(3)]
    pts = np.stack(np.meshgrid(*g, indexing="ij"), -1).reshape(-1, 3).astype(np.float32)
    staged = trainer.model.prepare_render_params(cfg, trainer.state.params)
    with torch.no_grad():
        d, _ = tfk.kplanes_density(cfg.field_config(), staged["fields"],
                                   trainer.aabb, torch.from_numpy(pts))
    np.testing.assert_array_equal(vol.reshape(-1), d.numpy())
    jcfg = jkm.Config(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})
    jparams = jax.tree_util.tree_map(
        lambda x: jnp.asarray(x.detach().numpy()), trainer.state.params["fields"])
    jd, _ = jfk.kplanes_density(jcfg.field_config(), jparams,
                                jnp.asarray(aabb), jnp.asarray(pts))
    jd = np.asarray(jd)
    assert np.abs(vol.reshape(-1) - jd).max() <= 1e-3 * np.abs(jd).max()
    assert vol.std() > 0


@pytest.mark.parametrize("iso", ["default", "median"])
def test_marching_cubes_mesh_is_jaxs_mesh_of_the_volume(snapshot, volume, tmp_path,
                                                        iso):
    """The mesh.ply of marching-cubes (at the default iso level 5, and at
    the volume's median, which crosses it) is byte for byte JAX's
    marching tetrahedra and PLY writer of the same volume."""
    _root, _data, config = snapshot
    _trainer, vol, aabb = volume
    extra = ["--resolution", "12"]
    level = 5.0
    if iso == "median":
        level = float(np.median(vol))
        extra += ["--iso-level", repr(level)]
    path = _export(config, "marching-cubes", tmp_path, *extra)
    spacing = (aabb[1] - aabb[0]) / 11
    verts, faces = jmarch.marching_tetrahedra(vol, level, aabb[0], spacing)
    jexp.write_ply(tmp_path / "jax_mesh.ply", verts, faces=faces)
    assert path.read_bytes() == (tmp_path / "jax_mesh.ply").read_bytes()
    if iso == "median":
        assert faces.shape[0] > 0


def test_pointcloud_and_poisson_and_tsdf_write_their_files(snapshot, volume,
                                                           tmp_path):
    """pointcloud: one coloured vertex per kept pixel (accumulation above
    0.5, every 4th row and column) of the rendered eval cameras; poisson
    a mesh of those points (or the JAX exporter's exit when none is kept);
    tsdf a mesh PLY."""
    _root, _data, config = snapshot
    trainer, _vol, _aabb = volume
    cams = trainer.eval_cameras
    kept = 0
    for i in range(min(10, cams.num_cameras)):
        acc = trainer.render_camera(cams, i)["accumulation"]
        kept += int((acc[::4, ::4] > 0.5).sum())
    path = _export(config, "pointcloud", tmp_path)
    head, counts = _ply_counts(path)
    assert counts == {"vertex": kept} and "property uchar red" in head
    if kept:
        path = _export(config, "poisson", tmp_path, "--resolution", "16")
        _head, counts = _ply_counts(path)
        assert counts["vertex"] > 0 and counts["face"] > 0
    else:
        with pytest.raises(SystemExit, match="no surface points"):
            _export(config, "poisson", tmp_path, "--resolution", "16")
    path = _export(config, "tsdf", tmp_path, "--resolution", "12")
    _head, counts = _ply_counts(path)
    assert set(counts) == {"vertex", "face"}


def test_density_export_refuses_a_model_without_planes(snapshot):
    """A model whose params hold no plane grids and that has no density_at
    exits, as the JAX exporter does."""
    _root, _data, config = snapshot
    _, trainer, _ = eval_setup(config, "inference", device=CPU)
    trainer.state.params = {"fields": {}}
    with pytest.raises(SystemExit, match="density export not supported"):
        texp.density_volume(trainer, 4, None)
