"""Port Step-3 building blocks (CG, multigrid, null-space projector) against
shm3d.solve, in float64 on the CPU, on constraint rows of a real source set
(the icosphere(2) mesh on its 16^3 and 32^3 grids).

Tolerances: 1e-12 relative where both packages run the same float64
arithmetic in another order; the pin masks, which shm3d builds in float32,
agree to float32 rounding (1e-7)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shm3d.solve import krylov as jkrylov
from shm3d.solve import multigrid as jmg
from shm3d.solve import projection as jproj
from shm3d_torch.domains import grid as griddom
from shm3d_torch.geometry import sources as src_mod
from shm3d_torch.geometry.procedural import make_icosphere
from shm3d_torch.solve import krylov, multigrid, projection

torch.set_num_threads(2)


@pytest.fixture(scope="module", params=[0.0, 1.0], ids=["16^3", "32^3"])
def rows(request):
    mesh = make_icosphere(2)
    src = src_mod.from_geometry(mesh)
    grid = griddom.build_grid(mesh.vertices, 2.0, request.param)
    nodes8, coeffs8 = griddom.constraint_rows(grid, src.points)
    return grid, nodes8, coeffs8


def _rel(a, b):
    return np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(np.asarray(b))


def test_cg_matches_shm3d_cg():
    rng = np.random.default_rng(5)
    A = rng.normal(size=(60, 60))
    A = A @ A.T + 5 * np.eye(60)
    b = rng.normal(size=60)
    d = np.diag(A)
    ref = jkrylov.cg(lambda x: jnp.asarray(A) @ x, jnp.asarray(b),
                     precond=lambda r: r / jnp.asarray(d), tol=1e-12, maxiter=500)
    At, dt = torch.tensor(A), torch.tensor(d)
    got = krylov.cg(lambda x: At @ x, torch.from_numpy(b), precond=lambda r: r / dt,
                    tol=1e-12, maxiter=500)
    assert abs(got.iterations - int(ref.iterations)) <= 1
    assert _rel(got.x.numpy(), ref.x) < 1e-10
    np.testing.assert_allclose(got.x.numpy(), np.linalg.solve(A, b), rtol=1e-9)


def test_cg_stall_window_stops_early():
    """A preconditioned residual that cannot shrink (tol below the float32
    floor) stops after the stall window, not at maxiter."""
    rng = np.random.default_rng(6)
    A = rng.normal(size=(30, 30)).astype(np.float32)
    A = A @ A.T + 30 * np.eye(30, dtype=np.float32)
    At = torch.from_numpy(A)
    b = torch.from_numpy(rng.normal(size=30).astype(np.float32))
    res = krylov.cg(lambda x: At @ x, b, tol=1e-30, maxiter=10_000, stall_window=20)
    assert res.iterations < 200
    assert np.isfinite(res.residual)


def test_pin_masks_match_shm3d(rows):
    grid, nodes8, _ = rows
    ref = jmg.build_pin_masks(nodes8, grid.shape)
    for dtype, atol in ((torch.float32, 0.0), (torch.float64, 1e-7)):
        got = multigrid.build_pin_masks(torch.from_numpy(nodes8), grid.shape, dtype)
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            assert g.dtype == dtype
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=atol)


def test_transfers_match_shm3d():
    rng = np.random.default_rng(7)
    r = rng.normal(size=(8, 8, 8))
    rt = torch.from_numpy(r)
    got = multigrid.restrict(rt)
    assert torch.equal(rt, torch.from_numpy(r))  # out of place
    np.testing.assert_allclose(got.numpy(), np.asarray(jmg.restrict(jnp.asarray(r))),
                               rtol=1e-13, atol=1e-13)
    np.testing.assert_allclose(multigrid.prolong(rt).numpy(),
                               np.asarray(jmg.prolong(jnp.asarray(r))), rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("pinned", [False, True], ids=["plain", "pins"])
def test_v_cycle_matches_shm3d(rows, pinned):
    """One V-cycle (and the flat preconditioner around it) on the same
    float64 pin masks in both packages."""
    grid, nodes8, _ = rows
    pins64 = tuple(np.asarray(m, np.float64) for m in jmg.build_pin_masks(nodes8, grid.shape))
    b = np.random.default_rng(8).normal(size=grid.total_nodes)
    jp = tuple(jnp.asarray(m) for m in pins64) if pinned else None
    tp = tuple(torch.from_numpy(m) for m in pins64) if pinned else None
    cell = grid.cell_size
    ref = jmg.make_node_preconditioner(grid.shape, cell, dtype=jnp.float64, pins=jp)(jnp.asarray(b))
    got = multigrid.make_node_preconditioner(grid.shape, cell, pins=tp)(torch.from_numpy(b))
    assert _rel(got.numpy(), ref) < 1e-12
    ref3 = jmg.v_cycle(jnp.asarray(b.reshape(grid.shape)), jnp.float64(cell), nu=2, pins=jp)
    got3 = multigrid.v_cycle(torch.from_numpy(b.reshape(grid.shape)), cell, nu=2, pins=tp)
    assert _rel(got3.numpy(), ref3) < 1e-12


def _projectors(grid, nodes8, coeffs8, arrays):
    N = grid.total_nodes
    jg = jproj.gram_from_arrays(arrays, jnp.float64)
    jp = jproj.make_projector(jnp.asarray(nodes8, jnp.int32), jnp.asarray(coeffs8), jg, N)
    tg = projection.gram_from_arrays(arrays, "cpu", torch.float64)
    tp = projection.make_projector(torch.from_numpy(nodes8.astype(np.int64)),
                                   torch.from_numpy(coeffs8), tg, N,
                                   projection.at_table(nodes8, coeffs8, "cpu", torch.float64))
    return jp, tp, tg


@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-13), (torch.float32, 1e-6)])
def test_at_apply_matches_shm3d(rows, dtype, rtol):
    """A^T z as a gather over the transposed table against the JAX
    package's scatter-add: float64 within 1e-13 and float32 within 1e-6 of
    max |A^T z| (<= 8 products per node summed in another order); two calls
    are bitwise equal.  The table holds each touched node once, its rows
    ascending, and ``build_at_table`` gives the JAX package's rows and
    coefficients (its hi part is the coefficients rounded to float32)."""
    grid, nodes8, coeffs8 = rows
    N = grid.total_nodes
    z = np.random.default_rng(11).normal(size=nodes8.shape[0])
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    ref = np.asarray(jproj.at_apply(jnp.asarray(z, jdt), jnp.asarray(nodes8, jnp.int32),
                                    jnp.asarray(coeffs8, jdt), N), np.float64)
    at = projection.at_table(nodes8, coeffs8, "cpu", dtype)
    zt = torch.as_tensor(z, dtype=dtype)
    got = projection.at_apply(zt, at, N)
    assert got.dtype == dtype and got.shape == (N,)
    assert torch.equal(got, projection.at_apply(zt, at, N))
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got.numpy().astype(np.float64), ref, rtol=0, atol=rtol * scale)
    # every touched node once, each row list ascending
    nodes = at.nodes.numpy()
    assert np.array_equal(nodes, np.unique(nodes8))
    r = at.rows.numpy()
    filled = at.coef.numpy() != 0
    assert all(np.all(np.diff(r[k][filled[k]]) > 0) for k in range(r.shape[0]))
    j_nodes, j_rows, j_hi, _ = jproj.build_at_table(nodes8, coeffs8)
    at_nodes, at_rows, at_c = projection.build_at_table(nodes8, coeffs8)
    np.testing.assert_array_equal(at_nodes, j_nodes)
    np.testing.assert_array_equal(at_rows, j_rows)
    np.testing.assert_array_equal(at_c.astype(np.float32), j_hi)


def test_bmat_projector_matches_shm3d_and_host(rows):
    grid, nodes8, coeffs8 = rows
    N = grid.total_nodes
    arrays = projection.build_gram_arrays(nodes8, coeffs8, N, "float64")
    ref_arrays = jproj.build_gram_arrays(nodes8, coeffs8, N, jnp.float64)
    assert arrays.keys() == ref_arrays.keys() and "bmat" in arrays
    for k in arrays:
        np.testing.assert_array_equal(arrays[k], ref_arrays[k])
    jp, tp, tg = _projectors(grid, nodes8, coeffs8, arrays)
    assert tg.tmat is None and tg.tform_eps is None
    v = np.random.default_rng(9).normal(size=N)
    got = tp(torch.from_numpy(v)).numpy()
    assert _rel(got, jp(jnp.asarray(v))) < 1e-12
    A, lu = jproj.host_gram_factor(nodes8, coeffs8, N)
    assert _rel(got, jproj.host_project(v, A, lu)) < 1e-10
    # P is a projector onto ker(A)
    assert np.abs(A @ got).max() < 1e-10 * np.abs(v).max()


def test_tmat_projector_matches_shm3d_and_host(rows):
    """The full-row whitening tier in float64: the same shifted Cholesky
    factor (eps = TFORM_FULL_EPS) in both packages.  Against the exact host
    projection the shift damps each mode of the scaled Gram with eigenvalue
    lam by (eps/lam)^2 after the refinement step, so the bound is
    2 (eps/lam_min)^2 plus float64 rounding (lam_min = 5.3e-4 at 16^3 and
    0.46 at 32^3 for these rows)."""
    grid, nodes8, coeffs8 = rows
    N = grid.total_nodes
    arrays = jproj.build_tform_full_arrays(nodes8, coeffs8, N)
    mine = projection.build_tform_full_arrays(nodes8, coeffs8, N)
    assert arrays.keys() == mine.keys()
    for k in arrays:
        np.testing.assert_array_equal(arrays[k], mine[k])
    jp, tp, tg = _projectors(grid, nodes8, coeffs8, arrays)
    assert tg.bmat is None and tg.tform_eps == projection.TFORM_FULL_EPS
    v = np.random.default_rng(10).normal(size=N)
    got = tp(torch.from_numpy(v)).numpy()
    assert _rel(got, jp(jnp.asarray(v))) < 1e-12
    A, lu = jproj.host_gram_factor(nodes8, coeffs8, N)
    G = (A @ A.T).toarray()
    d = np.sqrt(np.diag(G))
    lam_min = np.linalg.eigvalsh(G / np.outer(d, d))[0]
    bound = 2.0 * (projection.TFORM_FULL_EPS / lam_min) ** 2 + 1e-10
    assert _rel(got, jproj.host_project(v, A, lu)) < bound


def test_tform_eps_ladder_escalates_and_records():
    """A Gram table whose scaled matrix is indefinite at the first shifts:
    the factorization fails (reported through info), the shift grows x10,
    and the one that succeeded is recorded."""
    # scaled Gram [[1, 1], [1, 1]] - 1.5e-5 I: needs eps > 1.5e-5
    arr = {"idx": np.array([[0, 1], [0, 1]], np.int32),
           "val": np.array([[1.0, 1.0], [1.0, 1.0]]) - 1.5e-5 * np.eye(2),
           "diag": np.array([1.0, 1.0]) - 1.5e-5,
           "tform_eps": np.float64(3e-6)}
    g = projection.gram_from_arrays(arr, "cpu", torch.float64)
    assert g.tform_eps == pytest.approx(3e-5)
    arr["val"] = arr["val"] - 1.0 * np.eye(2)  # indefinite at every shift
    arr["diag"] = np.array([1.0, 1.0])
    with pytest.raises(RuntimeError, match="ROADMAP A10"):
        projection.gram_from_arrays(arr, "cpu", torch.float64)
