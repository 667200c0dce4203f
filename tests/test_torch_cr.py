"""Port Crouzeix-Raviart path and tet solver (shm3d_torch.tet) against
shm3d.tet.{cr_solver,solver}.

- f64, all three constraint modes, on the conforming cube fixture
  (tests/test_cr.py) through CRPath: phi within 1e-8 relative (the same
  AMG-CG in another summation order, converged to 1e-10);
- the paged branch in float32 (PAGED_MIN_NNZ forced to 1 in both
  packages): phi after defect correction within 1e-4 relative;
- the port's ``prepare`` against JAX's leaf by leaf, and ``from_prepared``
  on JAX's tree;
- the facade on tests/data/bunny_dec.obj (55,622 faces, conforming) in f64
  against ``shm3d.tet.solver.SignedHeatTetSolver``, within 1e-8 relative.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shm3d.oracle import reference as grid_oracle
from shm3d.tet import cr_solver as jcr
from shm3d.tet.solver import SignedHeatTetSolver as JaxTetSolver
from shm3d_torch import SignedHeatSolver
from shm3d_torch.config import LevelSetConstraint, SignedHeatOptions
from shm3d_torch.geometry import sources as src_mod
from shm3d_torch.geometry import surface as surf
from shm3d_torch.io.mesh_io import PointCloud, read_geometry
from shm3d_torch.solve import pell
from shm3d_torch.tet import cr_solver as tcr
from test_cr import _conforming_fixture
from test_torch_amg import assert_tree_close
from torch_interop import jax_geom, jax_options, jax_tetmesh, port_geom, port_tetmesh

torch.set_num_threads(2)

CUBE_SCALE = 1.0 / 0.8660254037844386   # tests/test_cr.py facade fixture
BUNNY = os.path.join(os.path.dirname(__file__), "data", "bunny_dec.obj")


@pytest.fixture(scope="module")
def cube():
    """(tet mesh, source mesh, surface face ids, Step-2 field, MULTIPLE-mode
    face components, source face areas), in the port's types; the JAX
    package's tet mesh of the same arrays is ``jax_tetmesh(tm)``."""
    tm, src_mesh, surf_ids, _ = _conforming_fixture()
    tm, src_mesh = port_tetmesh(tm), port_geom(src_mesh)
    src = src_mod.from_mesh(src_mesh)
    Y = grid_oracle.diffuse_vector_field(tm.barycenters(), src, 4.0)
    return (tm, src_mesh, surf_ids, Y, surf.connected_components_faces(src_mesh),
            src.weights)


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _integrate_both(cube, opts, jpath, tpath):
    _, _, _, Y, comps, areas = cube
    jdt = jnp.float32 if opts.dtype == "float32" else jnp.float64
    ref = np.asarray(jpath.integrate(jnp.asarray(Y, jdt), jax_options(opts),
                                     src_face_components=comps, src_face_areas=areas))
    got = tpath.integrate(torch.as_tensor(Y, dtype=tpath.dtype), opts,
                          src_face_components=comps, src_face_areas=areas)
    assert np.isfinite(got).all()
    return got, ref


@pytest.mark.parametrize("mode", list(LevelSetConstraint))
def test_cr_modes_match_jax_f64(cube, mode):
    tm, _, surf_ids, *_ = cube
    opts = SignedHeatOptions(dtype="float64", level_set_constraint=mode)
    jpath = jcr.CRPath(jax_tetmesh(tm), surf_ids, dtype=jnp.float64)
    tpath = tcr.CRPath(tm, surf_ids, dtype=np.float64, device="cpu")
    got, ref = _integrate_both(cube, opts, jpath, tpath)
    assert _rel(got, ref) <= 1e-8
    assert tpath.last_stats["amg_sizes"] == jpath.last_stats["amg_sizes"]


def test_cr_paged_f32_matches_jax(cube, monkeypatch):
    tm, _, surf_ids, *_ = cube
    monkeypatch.setattr(jcr, "PAGED_MIN_NNZ", 1)
    monkeypatch.setattr(tcr, "PAGED_MIN_NNZ", 1)
    opts = SignedHeatOptions(dtype="float32")
    jpath = jcr.CRPath(jax_tetmesh(tm), surf_ids, dtype=jnp.float32)
    tpath = tcr.CRPath(tm, surf_ids, dtype=np.float32, device="cpu")
    import shm3d.solve.pell as jpell

    assert isinstance(jpath.arrays["L"], jpell.PagedMat)
    # the port's paged operators are on the device as sliced ELL
    assert isinstance(tpath.arrays["L"], pell.SellMat)
    levels = tpath._hierarchy(LevelSetConstraint.ZERO_SET).levels
    assert levels[0].A is None and isinstance(levels[1].A, pell.SellMat)
    got, ref = _integrate_both(cube, opts, jpath, tpath)
    assert _rel(got, ref) <= 1e-4
    # float32 device solves, refined in f64 on the host
    assert len(tpath.last_stats["refine_pass_rels"]) >= 2
    assert tpath.last_stats["residual"] <= 1e-6


@pytest.mark.parametrize("dtype,paged", [("float64", False), ("float32", True)])
def test_prepare_and_from_prepared_match_jax(cube, monkeypatch, dtype, paged):
    tm, _, surf_ids, *_ = cube
    if paged:
        monkeypatch.setattr(jcr, "PAGED_MIN_NNZ", 1)
        monkeypatch.setattr(tcr, "PAGED_MIN_NNZ", 1)
    jprep = jcr.CRPath.prepare(jax_tetmesh(tm), surf_ids, np.dtype(dtype))
    tprep = tcr.CRPath.prepare(tm, surf_ids, np.dtype(dtype))
    assert sorted(tprep) == sorted(jprep)
    for k in tprep:
        if k == "ell":
            assert sorted(tprep[k]) == sorted(jprep[k])
            for name in tprep[k]:
                assert_tree_close(tprep[k][name], jprep[k][name], f"ell.{name}")
        elif k == "amg":
            assert sorted(tprep[k]) == sorted(jprep[k])
            for mode in tprep[k]:
                assert_tree_close(tprep[k][mode], jprep[k][mode], f"amg.{mode}")
        else:
            assert_tree_close(tprep[k], jprep[k], k)
    assert isinstance(tprep["ell"]["L"], pell.PagedMat) == paged
    # the port solves JAX's operators as it solves its own
    opts = SignedHeatOptions(dtype=dtype)
    # the JAX package's tree and mesh, read by field name
    tdev = tcr.CRPath.from_prepared(jax_tetmesh(tm), jprep, "cpu")
    own = tcr.CRPath(tm, device="cpu", prepared=tprep)
    _, _, _, Y, *_ = cube
    a = tdev.integrate(torch.as_tensor(Y, dtype=tdev.dtype), opts)
    b = own.integrate(torch.as_tensor(Y, dtype=own.dtype), opts)
    assert _rel(a, b) <= (1e-5 if paged else 1e-10)


def test_facade_bunny_matches_jax_f64():
    geom = read_geometry(BUNNY)
    opts = SignedHeatOptions(dtype="float64", disk_cache=False)
    jsolver = JaxTetSolver()
    ref = jsolver.compute_distance(jax_geom(geom), jax_options(opts))
    solver = SignedHeatSolver("tet", device="cpu")
    res = solver.compute_distance(geom, opts)
    assert res.mesh.conforming and res.mesh.n_faces == 55622
    assert solver.last_stats["step3_path"] == jsolver.last_stats["step3_path"] \
        == "crouzeix-raviart"
    assert res.phi.shape == ref.phi.shape and np.isfinite(res.phi).all()
    assert _rel(res.phi, ref.phi) <= 1e-8
    V, F = solver.isosurface(res, 0.0)
    assert V.shape[1] == 3 and F.shape[0] > 0


def test_facade_disk_cache_roundtrip(cube, tmp_path, monkeypatch):
    """A fresh solver reloads the prepared tree from the port's own
    disk-cache namespace and reproduces phi; the cube source mesh is
    lattice-aligned, so the CR path is found by face lookup."""
    monkeypatch.setenv("SHM3D_CACHE_DIR", str(tmp_path))
    _, src_mesh, *_ = cube
    opts = SignedHeatOptions(dtype="float64", scale=CUBE_SCALE, disk_cache=True)
    a = SignedHeatSolver("tet", device="cpu")
    ra = a.compute_distance(src_mesh, opts)
    assert a.last_stats["step3_path"] == "crouzeix-raviart"
    assert any(p.name.startswith("tree_") for p in tmp_path.iterdir())
    rb = SignedHeatSolver("tet", device="cpu").compute_distance(src_mesh, opts)
    np.testing.assert_array_equal(ra.phi, rb.phi)
    ref = JaxTetSolver().compute_distance(jax_geom(src_mesh),
                                          jax_options(opts.with_(disk_cache=False)))
    assert _rel(ra.phi, ref.phi) <= 1e-8


@pytest.mark.parametrize("case", ["point_cloud", "fast_integration", "device_mesh"])
def test_unported_tet_paths_raise(case):
    """The vertex path (point clouds), greedy integration and the CR solve
    on a device mesh are ported and solve."""
    if case == "device_mesh":
        from shm3d_torch.geometry.procedural import make_icosphere
        from shm3d_torch.parallel import device_mesh

        geom = make_icosphere(1)
        opts = SignedHeatOptions(dtype="float64", disk_cache=False)
        solver = SignedHeatSolver("tet", device="cpu", mesh=device_mesh(devices=["cpu"] * 4))
        got = solver.compute_distance(geom, opts).phi
        assert solver.last_stats["step3_path"] == "crouzeix-raviart"
        one = SignedHeatSolver("tet", device="cpu").compute_distance(geom, opts).phi
        # the ring sums the sources in another order: equal up to rounding
        assert _rel(got, one) <= 1e-12
        return
    geom = read_geometry(BUNNY)
    opts = SignedHeatOptions(dtype="float64", disk_cache=False)
    solver = SignedHeatSolver("tet", device="cpu")
    if case == "point_cloud":
        res = solver.compute_distance(
            PointCloud(geom.vertices.copy(), surf.vertex_normals(geom)), opts)
        assert solver.last_stats["step3_path"] == "vertex"
        assert not res.mesh.conforming
        assert np.abs(res.phi_at_sources()).max() == 0.0  # Dirichlet pinned
    else:
        res = solver.compute_distance(geom, opts.with_(fast_integration=True))
        assert solver.last_stats["step3_path"] == "greedy"
        assert np.abs(res.phi[np.unique(res.mesh.src_vertex)]).max() == 0.0  # seeds
    phi, verts = res.phi, res.mesh.vertices
    assert phi.shape == (res.mesh.n_vertices,) and np.isfinite(phi).all()
    # sign structure: positive away from the bunny, negative at its centroid
    c = geom.vertices.mean(axis=0)
    d = np.linalg.norm(verts - c, axis=1)
    radius = np.linalg.norm(geom.vertices - c, axis=1).max()
    assert np.median(phi[d > 1.5 * radius]) > 0
    assert phi[np.argmin(d)] < 0
