"""The port's own copies of the JAX package's host modules (NumPy, SciPy and
the native mesher core) against their originals on the same inputs, plus the
port's independence from the JAX package.

Every copy must give arrays equal to the original's: the logic is the same
code, so any difference is a fault of the copy.  The port's mesher core is
built by ``shm3d_torch._build`` with g++ from ``shm3d_torch/csrc/native``;
the JAX package's is the library under ``native/``.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from shm3d.domains import grid as jgriddom
from shm3d.geometry import sources as jsources
from shm3d.io import mesh_io as jmesh_io
from shm3d.ops import contour as jcontour
from shm3d.tet import fem as jfem
from shm3d.tet import mesher as jmesher
from shm3d.utils import order as jorder
from shm3d_torch import _build, api
from shm3d_torch.config import SignedHeatOptions
from shm3d_torch.domains import grid as griddom
from shm3d_torch.geometry import procedural
from shm3d_torch.geometry import sources
from shm3d_torch.io import mesh_io
from shm3d_torch.ops import contour
from shm3d_torch.solvers.grid import GridSolver
from shm3d_torch.tet import fem, mesher
from shm3d_torch.tet.solver import SignedHeatTetSolver
from shm3d_torch.utils import diskcache, order, treestore
from test_cr import _conforming_fixture
from torch_interop import jax_geom, jax_options, port_geom, port_tetmesh

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")


def _assert_fields_equal(got, ref, names, what=""):
    for k in names:
        a, b = getattr(got, k), getattr(ref, k)
        if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
            assert np.asarray(a).dtype == np.asarray(b).dtype, f"{what}{k}"
            np.testing.assert_array_equal(a, b, err_msg=f"{what}{k}")
        else:
            assert a == b, f"{what}{k}"


@pytest.fixture(scope="module")
def fixture_mesh():
    """(the JAX package's tet mesh of tests/test_cr.py's fixture, its source
    surface in the port's types)."""
    tm, src_mesh, _, _ = _conforming_fixture()
    return tm, port_geom(src_mesh)


@pytest.mark.parametrize("name", ["bunny_dec.obj", "knot_dec.obj"])
def test_read_geometry(name):
    got = mesh_io.read_geometry(os.path.join(DATA, name))
    ref = jmesh_io.read_geometry(os.path.join(DATA, name))
    assert isinstance(got, mesh_io.Mesh)
    _assert_fields_equal(got, ref, ("vertices", "faces", "degrees"))


@pytest.mark.parametrize("kind", ["mesh", "point_cloud"])
def test_sources_from_geometry(kind):
    geom = (procedural.make_icosphere(2) if kind == "mesh"
            else procedural.make_sphere_cloud(1500))
    got = sources.from_geometry(geom)
    ref = jsources.from_geometry(jax_geom(geom))
    _assert_fields_equal(got, ref, ("points", "normals", "weights", "spacing"))
    np.testing.assert_array_equal(got.vectors(), ref.vectors())


@pytest.mark.parametrize("h_coef", [0.0, 1.0])
def test_grid_rows(h_coef):
    geom = procedural.make_sphere_cloud(1500)
    src = sources.from_geometry(geom).points
    got = griddom.build_grid(geom.positions, 2.0, h_coef)
    ref = jgriddom.build_grid(geom.positions, 2.0, h_coef)
    _assert_fields_equal(got, ref, ("bbox_min", "cell_size", "n"))
    for fn in ("constraint_rows", "trilinear_rows"):
        for a, b in zip(getattr(griddom, fn)(got, src), getattr(jgriddom, fn)(ref, src)):
            np.testing.assert_array_equal(a, b, err_msg=fn)


def test_cr_operators(fixture_mesh):
    tm, _ = fixture_mesh
    got = fem.build_cr_operators(port_tetmesh(tm))
    ref = jfem.build_cr_operators(tm)
    _assert_fields_equal(got, ref, ("L_rows", "L_cols", "L_vals", "M_rows", "M_cols",
                                    "M_vals", "div_faces", "div_tets", "div_nvec",
                                    "avg_faces", "n_faces", "n_vertices"))


def test_morton_order():
    pts = np.random.default_rng(0).uniform(-3, 5, (20000, 3))
    perm = order.morton_order(pts)
    np.testing.assert_array_equal(perm, jorder.morton_order(pts))
    np.testing.assert_array_equal(order.morton_codes(pts), jorder.morton_codes(pts))
    np.testing.assert_array_equal(order.inverse_permutation(perm),
                                  jorder.inverse_permutation(perm))


def test_contour(fixture_mesh):
    tm, _ = fixture_mesh
    phi = np.linalg.norm(tm.vertices, axis=1) - 0.6
    for a, b in zip(contour.marching_tets(tm.vertices, tm.tets, phi, 0.0),
                    jcontour.marching_tets(tm.vertices, tm.tets, phi, 0.0)):
        np.testing.assert_array_equal(a, b)
    grid = griddom.build_grid(tm.vertices, 2.0, 0.0)
    gphi = np.linalg.norm(grid.node_positions(), axis=1) - 0.6
    for a, b in zip(contour.grid_isosurface(grid, gphi, 0.0),
                    jcontour.grid_isosurface(grid, gphi, 0.0)):
        assert a.shape[0] > 0
        np.testing.assert_array_equal(a, b)


_MESH_FIELDS = ("vertices", "tets", "faces", "tet_face", "tet_face_sign", "vt_indptr",
                "vt_data", "n_src", "src_vertex", "n_snapped", "n_split", "conforming",
                "surface_faces", "surface_parent", "surface_orient")


@pytest.mark.parametrize("conforming", [False, True])
def test_build_tet_domain(fixture_mesh, conforming):
    """The port's mesher, with its own g++ build of the native core, meshes
    as the JAX package does: equal arrays."""
    _, src = fixture_mesh
    pts = src.vertices
    scale = 1.0 / np.linalg.norm(pts, axis=1).max()
    faces = src.triangles() if conforming else None
    got = mesher.build_tet_domain(pts, scale=scale, resolution=8, src_faces=faces)
    ref = jmesher.build_tet_domain(pts, scale=scale, resolution=8, src_faces=faces)
    assert got.conforming == conforming
    _assert_fields_equal(got, ref, _MESH_FIELDS)
    assert _build.native_library_path().exists()


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """A failed build of the mesher core raises with the compiler's log; it
    never falls back to the NumPy mesher."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_NATIVE_LIB", None)
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="build of libshm3d_torch_native"):
        _build.load_native_library()
    assert not list(tmp_path.glob("*.so"))


def test_store_roundtrips(fixture_mesh, tmp_path, monkeypatch):
    """The port's diskcache and treestore write and read their own
    entries (the port's namespaces), the tet mesh through the port's packed
    encoding."""
    monkeypatch.setenv("SHM3D_CACHE_DIR", str(tmp_path))
    arrays = {"a": np.arange(5.0), "b": np.eye(3, dtype=np.float32)}
    diskcache.save(("grid_torch", "g2", "k"), arrays)
    back = diskcache.load(("grid_torch", "g2", "k"))
    for k in arrays:
        np.testing.assert_array_equal(back[k], arrays[k])
    assert diskcache.load(("grid", "g2", "k")) is None
    tm = port_tetmesh(fixture_mesh[0])
    treestore.save_tree(("tetprep_torch", "c1", "k"), {"mesh": tm, "x": np.ones(3)})
    tree = treestore.load_tree(("tetprep_torch", "c1", "k"))
    assert isinstance(tree["mesh"], mesher.TetMesh)
    _assert_fields_equal(tree["mesh"], tm, _MESH_FIELDS)
    np.testing.assert_array_equal(tree["x"], np.ones(3))


def test_port_imports_neither_jax_nor_shm3d():
    code = (
        "import importlib, pkgutil, sys\n"
        "import shm3d_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(shm3d_torch.__path__, 'shm3d_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'shm3d'))\n"
        "assert not bad, bad\n"
        "print(len(names), 'OK')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr
    count = int(out.stdout.split()[0])
    assert count >= 30 and out.stdout.strip().endswith("OK")


@pytest.mark.parametrize("entry", ["api_grid", "api_tet", "grid_solver", "tet_solver"])
@pytest.mark.parametrize("foreign", ["options", "geometry"])
def test_entry_points_refuse_jax_package_types(entry, foreign):
    geom = procedural.make_icosphere(1)
    opts = SignedHeatOptions(dtype="float64", refine_steps=0, disk_cache=False)
    if foreign == "options":
        opts = jax_options(opts)
    else:
        geom = jax_geom(geom)
    solver = {"api_grid": lambda: api.SignedHeatSolver("grid", device="cpu"),
              "api_tet": lambda: api.SignedHeatSolver("tet", device="cpu"),
              "grid_solver": lambda: GridSolver(device="cpu"),
              "tet_solver": lambda: SignedHeatTetSolver(device="cpu")}[entry]()
    with pytest.raises(TypeError, match="shm3d_torch"):
        solver.compute_distance(geom, opts)
