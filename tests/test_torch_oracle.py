"""The port's float64 host oracles (shm3d_torch.oracle.reference and
.tet_reference, NumPy/SciPy direct solves) against the JAX package's on the
same inputs, the port's counterparts of tests/test_oracle_grid.py (grid
operators and the oracle pipeline) and of
tests/test_device_grid.py::test_grid_pipeline_matches_oracle_f64 (the
port's grid solve against its own oracle).

Both oracles are the same code over copies of the same host modules, so
they agree to rounding (1e-12).
"""

import numpy as np
import pytest
import torch

from shm3d.oracle import reference as jref
from shm3d.oracle import tet_reference as jtet
from shm3d_torch.config import LevelSetConstraint, SignedHeatOptions
from shm3d_torch.domains import grid as griddom
from shm3d_torch.geometry import sources as src_mod
from shm3d_torch.geometry.procedural import make_icosphere
from shm3d_torch.io.mesh_io import PointCloud
from shm3d_torch.oracle import reference as oracle
from shm3d_torch.oracle import tet_reference
from shm3d_torch.solvers.grid import GridSolver
from torch_interop import jax_geom, jax_options

torch.set_num_threads(2)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _cloud(mesh):
    v = mesh.vertices
    return PointCloud(v.copy(), v / np.linalg.norm(v, axis=1, keepdims=True))


@pytest.mark.parametrize("case", ["mesh", "mesh_fast", "points"])
def test_grid_oracle_matches_shm3d(case):
    mesh = make_icosphere(2)
    geom = _cloud(mesh) if case == "points" else mesh
    opts = SignedHeatOptions(fast_integration=case == "mesh_fast")
    got = oracle.solve_grid(geom, opts)
    ref = jref.solve_grid(jax_geom(geom), jax_options(opts))
    assert _rel(got.Y, ref.Y) < 1e-12
    assert _rel(got.phi, ref.phi) < 1e-12


_TET_CASES = {
    "cr_zero_set": {},
    "cr_none": dict(level_set_constraint=LevelSetConstraint.NONE),
    "vertex_zero_set": dict(use_crouzeix_raviart=False),
    "vertex_multiple": dict(use_crouzeix_raviart=False,
                            level_set_constraint=LevelSetConstraint.MULTIPLE),
    "vertex_none": dict(use_crouzeix_raviart=False,
                        level_set_constraint=LevelSetConstraint.NONE),
    "greedy": dict(fast_integration=True),
    "point_cloud": dict(level_set_constraint=LevelSetConstraint.NONE),
}


@pytest.mark.parametrize("case", list(_TET_CASES))
def test_tet_oracle_matches_shm3d(case):
    mesh = make_icosphere(1)
    geom = _cloud(mesh) if case == "point_cloud" else mesh
    opts = SignedHeatOptions(**_TET_CASES[case])
    got = tet_reference.solve_tet(geom, opts)
    ref = jtet.solve_tet(jax_geom(geom), jax_options(opts))
    np.testing.assert_array_equal(got.mesh.tets, ref.mesh.tets)
    assert np.isfinite(got.phi).all()
    assert _rel(got.phi, ref.phi) < 1e-12


# --- counterparts of tests/test_oracle_grid.py on the port's modules -------


def test_grid_spec_matches_reference_formulas():
    pts = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 2.0, 0.0]])
    g = griddom.build_grid(pts, scale=2.0, h_coef=0.0)
    c = pts.mean(axis=0)
    r = np.max(np.linalg.norm(pts - c, axis=1))
    assert g.n == 16
    assert np.allclose(g.bbox_min, c - 2.0 * r)
    assert np.isclose(g.cell_size, 2.0 * (2.0 * r) / (g.n - 1))
    pos = g.node_positions()
    assert pos.shape == (16 ** 3, 3)
    assert np.allclose(pos[g.flat_index(3, 5, 7)],
                       np.asarray(g.bbox_min) + np.array([3, 5, 7]) * g.cell_size)


def test_laplacian_row_sums_and_symmetry():
    g = griddom.GridSpec((0.0, 0.0, 0.0), 0.5, 5)
    L = griddom.laplacian_matrix(g)
    assert np.allclose(np.abs(L.sum(axis=1)), 0.0)
    assert (L != L.T).nnz == 0
    idx = g.flat_index(2, 2, 2)
    row = L.getrow(idx).toarray().ravel()
    assert np.isclose(row[idx], -6.0 / 0.25)
    for nb in (g.flat_index(1, 2, 2), g.flat_index(3, 2, 2), g.flat_index(2, 1, 2),
               g.flat_index(2, 3, 2), g.flat_index(2, 2, 1), g.flat_index(2, 2, 3)):
        assert np.isclose(row[nb], 1.0 / 0.25)
    corner = g.flat_index(0, 0, 0)
    assert np.isclose(L[corner, corner], -3.0 / 0.25)


def test_gradient_exact_on_linear_function_and_adjoint():
    g = griddom.GridSpec((-1.0, 0.0, 2.0), 0.25, 6)
    D = griddom.gradient_matrix(g)
    coef = np.array([2.0, -3.0, 0.5])
    u = g.node_positions() @ coef + 1.7
    np.testing.assert_allclose((D @ u).reshape(-1, 3), np.tile(coef, (g.total_nodes, 1)),
                               atol=1e-12)
    rng = np.random.default_rng(0)
    u, Y = rng.normal(size=g.total_nodes), rng.normal(size=3 * g.total_nodes)
    assert np.isclose(Y @ (D @ u), (D.T @ Y) @ u)


def test_trilinear_rows_and_constraint_dedup():
    g = griddom.GridSpec((0.0, 0.0, 0.0), 0.5, 8)
    q = np.random.default_rng(1).uniform(0.3, 3.0, size=(50, 3))
    _, coeffs = griddom.trilinear_rows(g, q)
    assert np.allclose(coeffs.sum(axis=1), 1.0)
    coef = np.array([1.0, 2.0, -1.0])
    u = g.node_positions() @ coef + 0.3
    np.testing.assert_allclose(griddom.evaluate_trilinear(g, u, q), q @ coef + 0.3, atol=1e-12)
    g4 = griddom.GridSpec((0.0, 0.0, 0.0), 1.0, 4)
    nodes, _ = griddom.constraint_rows(
        g4, np.array([[0.5, 0.5, 0.5], [0.6, 0.4, 0.3], [1.5, 0.5, 0.5]]))
    assert nodes.shape[0] == 2
    assert np.isclose(oracle.yukawa_potential(np.zeros(3), np.array([0.0, 3.0, 4.0]), 0.5),
                      np.exp(-2.5) / 5.0)


@pytest.mark.parametrize("fast", [False, True])
def test_oracle_sphere_signed_distance(fast):
    """The oracle's phi of a sphere approximates |x| - 1 near the surface,
    negative inside and positive outside, and (exact solve) pins the
    interpolant near 0 at the sources."""
    mesh = make_icosphere(2, radius=1.0)
    res = oracle.solve_grid(mesh, SignedHeatOptions(fast_integration=fast))
    r = np.linalg.norm(res.grid.node_positions(), axis=1)
    band = np.abs(r - 1.0) < 0.5
    assert _rel(res.phi[band], (r - 1.0)[band]) < (0.6 if fast else 0.25)
    assert np.mean(res.phi[r < 0.6] < 0) > 0.95
    assert np.mean(res.phi[(r > 1.4) & (r < 1.9)] > 0) > 0.95
    if not fast:
        vals = griddom.evaluate_trilinear(res.grid, res.phi, src_mod.from_mesh(mesh).points)
        assert np.abs(vals).max() < 0.05 * np.abs(res.phi).max()


@pytest.mark.parametrize("geom_kind", ["mesh", "points"])
def test_grid_pipeline_matches_oracle_f64(geom_kind):
    mesh = make_icosphere(2)
    geom = mesh if geom_kind == "mesh" else _cloud(mesh)
    opts = SignedHeatOptions(dtype="float64", solver_tol=1e-12, solver_maxiter=20000,
                             refine_steps=0, disk_cache=False)
    expected = oracle.solve_grid(geom, opts)
    got = GridSolver(device="cpu").compute_distance(geom, opts)
    assert _rel(got.phi, expected.phi) < 1e-6
