"""Port tet vertex (dual-Laplacian) path, greedy integration and the
artifact's mode upgrades (shm3d_torch.tet.solver) against shm3d.tet.solver.

Inputs are the procedural icosphere, a quad cube and numpy seeds; both
packages run on the CPU, in f64 unless said.

- ``_divergence`` against ``shm3d.tet.solver._divergence_jit`` within 1e-13
  relative (the same products summed per row in another order), and two
  calls bit for bit;
- ``_prepare_host`` leaf by leaf against the JAX package's for a point cloud
  and for ``use_crouzeix_raviart=False``: integers exact, floats within
  1e-12 of the leaf's largest magnitude (the same host code);
- the vertex solve in all three modes, on the icosphere as a point cloud
  on a quad cube and on a non-conforming tet mesh: rel-L2 <= 1e-8 at ``solver_tol=1e-12`` (the same
  AMG-CG in another summation order), ZERO_SET sources exactly 0;
- the scaled-null-space modes NONE and MULTIPLE in float32 against f64
  within 2e-4 (the bar of tests/test_equilibration.py: a wrong deflation
  direction shows up directly in phi);
- greedy integration in all three modes and with a singleton component:
  <= 1e-12 relative (the host code is the same; the Step-2 fields differ by
  rounding);
- both mode upgrades and the disk round-trip in a ``tmp_path`` cache.
"""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shm3d.tet import solver as jsolver_mod
from shm3d.tet.solver import SignedHeatTetSolver as JaxTetSolver
from shm3d_torch import SignedHeatSolver
from shm3d_torch.config import LevelSetConstraint, SignedHeatOptions
from shm3d_torch.geometry.procedural import make_icosphere
from shm3d_torch.io.mesh_io import Mesh, PointCloud
from shm3d_torch.solve import pell
from shm3d_torch.tet import fem
from shm3d_torch.tet import solver as tsolver_mod
from shm3d_torch.tet.mesher import build_tet_domain
from shm3d_torch.tet.solver import SignedHeatTetSolver, solve_tet
from torch_interop import jax_geom, jax_options

torch.set_num_threads(2)

MODES = list(LevelSetConstraint)
TIGHT = dict(dtype="float64", solver_tol=1e-12, solver_maxiter=60000,
             refine_steps=0, disk_cache=False)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _quad_cube() -> Mesh:
    v = np.array([[i, j, k] for k in (0., 1) for j in (0., 1) for i in (0., 1)])
    quads = [[0, 2, 3, 1], [4, 5, 7, 6], [0, 1, 5, 4], [2, 6, 7, 3],
             [0, 4, 6, 2], [1, 3, 7, 5]]  # outward orientation
    return Mesh.from_face_lists(v, quads)


def _cloud(mesh) -> PointCloud:
    v = mesh.vertices
    return PointCloud(v.copy(), v / np.linalg.norm(v, axis=1, keepdims=True))


@pytest.fixture(scope="module")
def ico():
    return make_icosphere(2)


@pytest.fixture(scope="module")
def solvers():
    """One solver of each package for the whole module: the icosphere is
    meshed once per package, every mode reuses its cached operators."""
    return JaxTetSolver(), SignedHeatTetSolver(device="cpu")


def _both(solvers, geom, opts):
    jsolver, tsolver = solvers
    ref = jsolver.compute_distance(jax_geom(geom), jax_options(opts))
    got = tsolver.compute_distance(geom, opts)
    assert np.isfinite(got.phi).all() and got.phi.shape == ref.phi.shape
    return got, ref, dict(tsolver.last_stats), dict(jsolver.last_stats)


# --- the divergence ---------------------------------------------------------


def test_divergence_matches_jax_and_repeats(ico):
    tm = build_tet_domain(ico.vertices, 2.0, 0.0, mean_area=0.05)
    dual = fem.build_dual_laplacian(tm)
    Y = np.random.default_rng(0).standard_normal((tm.n_tets, 3))
    n = tm.n_vertices
    ref = np.asarray(jsolver_mod._divergence_jit(
        jnp.asarray(Y), jnp.asarray(dual.div_rows, jnp.int32),
        jnp.asarray(dual.div_tets, jnp.int32), jnp.asarray(dual.div_gvec), n))
    args = (torch.as_tensor(Y), torch.as_tensor(dual.div_rows, dtype=torch.int64),
            torch.as_tensor(dual.div_tets, dtype=torch.int32),
            torch.as_tensor(dual.div_gvec), n)
    got = tsolver_mod._divergence(*args)
    assert got.dtype == torch.float64 and got.shape == (n,)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-13 * np.abs(ref).max())
    np.testing.assert_allclose(got.numpy(), dual.divergence_np(Y), rtol=0,
                               atol=1e-13 * np.abs(ref).max())
    assert torch.equal(got, tsolver_mod._divergence(*args))


# --- the host tree ----------------------------------------------------------


def _assert_leaves_close(a, b, path):
    """Port tree ``a`` against JAX tree ``b``: same structure by field name,
    integers exact, floats within 1e-12 of the leaf's largest magnitude."""
    if a is None:
        assert b is None, path
    elif isinstance(a, pell.PagedMat):
        A, B = pell.to_scipy(a), pell.to_scipy(tsolver_mod.tree_mod.adopt(b))
        assert a.nnz == b.nnz and A.shape == B.shape, path
        assert abs(A - B).max() <= 1e-12 * abs(B).max(), path
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _assert_leaves_close(a[k], b[k], f"{path}.{k}")
    elif dataclasses.is_dataclass(a) or hasattr(a, "_fields"):
        assert type(a).__name__ == type(b).__name__, path
        names = a._fields if hasattr(a, "_fields") else \
            [f.name for f in dataclasses.fields(a)]
        for f in names:
            _assert_leaves_close(getattr(a, f), getattr(b, f), f"{path}.{f}")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), path
        for k, (u, v) in enumerate(zip(a, b)):
            _assert_leaves_close(u, v, f"{path}[{k}]")
    elif isinstance(a, np.ndarray):
        b = np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, path
        if a.dtype.kind == "f":
            scale = np.abs(b).max() if b.size else 0.0
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-12 * scale, err_msg=path)
        else:
            np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


@pytest.mark.parametrize("case", ["point_cloud", "no_cr", "greedy"])
def test_prepare_host_matches_jax(ico, case):
    geom = _cloud(ico) if case == "point_cloud" else ico
    opts = SignedHeatOptions(
        dtype="float32" if case == "no_cr" else "float64", disk_cache=False,
        use_crouzeix_raviart=case != "no_cr", fast_integration=case == "greedy")
    tprep = SignedHeatTetSolver(device="cpu")._prepare_host(geom, opts)
    jprep = JaxTetSolver()._prepare_host(jax_geom(geom), jax_options(opts))
    jprep.pop("vertex_v")  # the JAX package's stale-artifact gate, not ported
    _assert_leaves_close(tprep, jprep, "prepared")
    # mode-aware: the vertex family where this mode needs it, CR never here
    assert tprep["cr"] is None
    has_vertex = case != "greedy"
    assert (tprep["H_csr"] is not None) == has_vertex
    assert ("H_ell" in tprep["dev"]) == has_vertex
    assert sorted(tprep["vamg"]) == (["zero_set"] if has_vertex else [])


def test_component_rows_match_jax():
    labels = np.array([0, 0, 0, 0, 1, 1])
    src_vertex = np.array([7, 9, 9, 11, 3, 3])  # coincident inputs merged
    got = tsolver_mod._component_rows(labels, src_vertex)
    ref = jsolver_mod._component_rows(labels, src_vertex)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    assert list(got[0]) == [7, 7] and list(got[1]) == [9, 11]


def test_weighted_group_projector_is_an_orthogonal_projector():
    rng = np.random.default_rng(3)
    n, elems = 40, torch.as_tensor(rng.permutation(40)[:17])
    gids = torch.as_tensor(rng.integers(0, 3, 17))
    u = torch.as_tensor(rng.uniform(0.5, 2.0, 17))
    uinv = 1.0 / torch.zeros(3, dtype=torch.float64).index_add_(0, gids, u * u)
    P = tsolver_mod._group_projector(elems, gids, uinv, 3, group_u=u)
    x, y = torch.as_tensor(rng.standard_normal(n)), torch.as_tensor(rng.standard_normal(n))
    Px, Py = P(x), P(y)
    assert torch.allclose(P(Px), Px, rtol=0, atol=1e-14)
    assert abs(float(torch.dot(Px, y) - torch.dot(x, Py))) <= 1e-13
    # within a group the image is proportional to u
    ratio = (Px[elems] / u)[gids == 0]
    assert float(ratio.max() - ratio.min()) <= 1e-14


# --- the vertex solve -------------------------------------------------------


@pytest.mark.parametrize("case", ["zero_set", "none", "multiple", "point_cloud",
                                  "quad_cube", "non_conforming"])
def test_vertex_solve_matches_jax_f64(ico, solvers, case):
    mode = LevelSetConstraint(case) if case in [m.value for m in MODES] \
        else LevelSetConstraint.ZERO_SET
    geom = {"point_cloud": _cloud(ico), "quad_cube": _quad_cube()}.get(case, ico)
    # without a conforming mesh the default options fall back to the vertex
    # path by themselves
    opts = SignedHeatOptions(level_set_constraint=mode,
                             use_crouzeix_raviart=case == "non_conforming",
                             conforming=case != "non_conforming", **TIGHT)
    got, ref, tstats, jstats = _both(solvers, geom, opts)
    assert tstats["step3_path"] == jstats["step3_path"] == "vertex"
    assert tstats["amg_sizes"] == jstats["amg_sizes"]
    assert _rel(got.phi, ref.phi) <= 1e-8
    if mode == LevelSetConstraint.ZERO_SET:
        assert np.abs(got.phi_at_sources()).max() == 0.0
    if case == "quad_cube":
        center = np.linalg.norm(got.mesh.vertices - 0.5, axis=1)
        assert np.median(got.phi[center < 0.25]) < 0 < np.median(got.phi[center > 1.2])


@pytest.mark.parametrize("mode", [LevelSetConstraint.NONE, LevelSetConstraint.MULTIPLE])
def test_scaled_nullspace_modes_f32_match_f64(ico, solvers, mode):
    opts = SignedHeatOptions(
        dtype="float32", level_set_constraint=mode, use_crouzeix_raviart=False,
        refine_steps=0, solver_tol=1e-6, solver_maxiter=20000, disk_cache=False)
    jsolver, tsolver = solvers
    ref = jsolver.compute_distance(
        jax_geom(ico), jax_options(opts.with_(dtype="float64", solver_tol=1e-12)))
    got = tsolver.compute_distance(ico, opts)
    cached = next(v for k, v in tsolver._cache.items() if "float32" in k[1])
    # float32: every H application goes through the sliced-ELL operator
    assert isinstance(cached["H_ell"], pell.SellMat)
    assert cached["H_ell"].vals.dtype == torch.float32
    assert _rel(got.phi, ref.phi) < 2e-4


def test_vertex_solve_f32_refines_in_f64(ico):
    """The default float32 tier: f64 defect correction on the host drives
    the residual below the float32 solve's, sources stay exactly 0."""
    opts = SignedHeatOptions(use_crouzeix_raviart=False, disk_cache=False)
    solver = SignedHeatSolver("tet", device="cpu")
    res = solver.compute_distance(ico, opts)
    st = solver.last_stats
    assert st["step3_path"] == "vertex" and len(st["refine_pass_rels"]) >= 2
    assert st["refine_pass_rels"][-1] < st["refine_pass_rels"][0]
    assert st["residual"] == st["refine_pass_rels"][-1] <= 1e-6
    assert np.abs(res.phi_at_sources()).max() == 0.0
    again = solver.compute_distance(ico, opts)
    np.testing.assert_array_equal(again.phi, res.phi)
    ref = JaxTetSolver().compute_distance(jax_geom(ico), jax_options(opts))
    assert _rel(res.phi, ref.phi) <= 1e-5


# --- greedy -----------------------------------------------------------------


def _with_singleton(ico) -> Mesh:
    verts = np.concatenate([ico.vertices, [[2.5, 0.0, 0.0]]], axis=0)
    return Mesh.from_face_lists(verts, [list(f) for f in ico.triangles()])


@pytest.mark.parametrize("case", ["zero_set", "none", "multiple", "singleton"])
def test_greedy_matches_jax(ico, solvers, case):
    mode = LevelSetConstraint.MULTIPLE if case == "singleton" else LevelSetConstraint(case)
    geom = _with_singleton(ico) if case == "singleton" else ico
    opts = SignedHeatOptions(dtype="float64", fast_integration=True,
                             level_set_constraint=mode, disk_cache=False)
    got, ref, tstats, jstats = _both(solvers, geom, opts)
    assert tstats["step3_path"] == jstats["step3_path"] == "greedy"
    assert _rel(got.phi, ref.phi) <= 1e-12
    if case == "singleton":
        labels = np.r_[np.zeros(ico.vertices.shape[0], int), 1]
        phi_src = got.phi_at_sources()
        assert np.ptp(phi_src[labels == 0]) == 0.0
        assert abs(phi_src[labels == 1][0] - phi_src[0]) > 0.2


# --- mode-aware artifacts ---------------------------------------------------


def _tree_arrays(tmp_path):
    keys = set()
    for d in os.listdir(tmp_path):
        mf = os.path.join(tmp_path, d, "manifest.json")
        if d.startswith("tree_") and os.path.exists(mf):
            with open(mf) as f:
                keys |= set(json.load(f)["arrays"])
    return keys


def _fresh():
    return SignedHeatTetSolver(device="cpu")


def test_cr_artifact_lacks_vertex_state_then_upgrades(ico, tmp_path, monkeypatch):
    monkeypatch.setenv("SHM3D_CACHE_DIR", str(tmp_path))
    opts = SignedHeatOptions(dtype="float32")
    s1 = _fresh()
    r1 = s1.compute_distance(ico, opts)
    assert s1.last_stats["step3_path"] == "crouzeix-raviart"
    keys = _tree_arrays(tmp_path)
    assert any(".cr." in k for k in keys)
    assert not any("H_ell" in k for k in keys), sorted(keys)[:10]

    # use_crouzeix_raviart=False in a fresh solver: the vertex operators are
    # built from the cached mesh and merged back into the artifact
    nocr = opts.with_(use_crouzeix_raviart=False)
    s2 = _fresh()
    r2 = s2.compute_distance(ico, nocr)
    assert s2.last_stats["step3_path"] == "vertex"
    assert any("H_ell" in k for k in _tree_arrays(tmp_path))
    assert len([d for d in os.listdir(tmp_path) if d.startswith("tree_")]) == 1

    # a third solver loads the upgraded artifact (it cannot rebuild: the
    # function that would is removed) and defers the vertex arrays while CR
    # is active
    monkeypatch.setattr(SignedHeatTetSolver, "_build_vertex_ops", None)
    s3 = _fresh()
    r4 = s3.compute_distance(ico, opts)
    cached = next(iter(s3._cache.values()))
    assert "H_ell" not in cached and cached["_vertex_host"] is not None
    np.testing.assert_array_equal(r4.phi, r1.phi)
    r3 = s3.compute_distance(ico, nocr)
    assert s3.last_stats["step3_path"] == "vertex"
    assert cached.get("_vertex_host") is None and "H_ell" in cached
    np.testing.assert_array_equal(r3.phi, r2.phi)


def test_greedy_artifact_upgrades_to_cr(ico, tmp_path, monkeypatch):
    monkeypatch.setenv("SHM3D_CACHE_DIR", str(tmp_path))
    opts = SignedHeatOptions(dtype="float32")
    s0 = _fresh()
    s0.compute_distance(ico, opts.with_(fast_integration=True))
    assert s0.last_stats["step3_path"] == "greedy"
    keys = _tree_arrays(tmp_path)
    assert not any(".cr.ell" in k for k in keys)
    assert not any("H_ell" in k for k in keys)

    # an exact solve on the same solver, then on the greedy-keyed artifact in
    # a fresh one: CR state builds on demand, in a phase of its own, and
    # matches a from-scratch CR solve bit for bit
    ref = _fresh().compute_distance(ico, opts.with_(disk_cache=False))
    r0 = s0.compute_distance(ico, opts)
    assert s0.last_stats["step3_path"] == "crouzeix-raviart"
    assert any("mode upgrade" in p for p in s0.last_stats["phases"])
    assert any(".cr.ell" in k for k in _tree_arrays(tmp_path))
    np.testing.assert_array_equal(r0.phi, ref.phi)

    monkeypatch.setattr(tsolver_mod.fem, "build_cr_operators", None)  # no rebuild
    s1 = _fresh()
    r1 = s1.compute_distance(ico, opts)
    assert s1.last_stats["step3_path"] == "crouzeix-raviart"
    assert not any("mode upgrade" in p for p in s1.last_stats["phases"])
    np.testing.assert_array_equal(r1.phi, ref.phi)


def test_vertex_disk_roundtrip(ico, tmp_path, monkeypatch):
    """A point cloud's artifact (vertex family, eager hierarchy) reloads in a
    fresh solver and reproduces phi; ``solve_tet`` is the one-call form."""
    monkeypatch.setenv("SHM3D_CACHE_DIR", str(tmp_path))
    cloud = _cloud(ico)
    opts = SignedHeatOptions(dtype="float64")
    ra = _fresh().compute_distance(cloud, opts)
    assert any("H_ell" in k for k in _tree_arrays(tmp_path))
    monkeypatch.setattr(tsolver_mod, "build_tet_domain", None)  # disk hit only
    rb = solve_tet(cloud, opts, device="cpu")
    np.testing.assert_array_equal(ra.phi, rb.phi)
