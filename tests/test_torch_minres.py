"""The grid's MINRES-on-KKT Step 3 (``solver_method="minres_kkt"``) in the
port against shm3d's, float64 on the CPU unless a case says otherwise.

- ``krylov.minres`` on tests/test_device_grid.py's two small systems: the
  same iterations, x within 1e-10 and phibar within 1e-10 of the
  starting residual's norm, on flat vectors and on KKT pairs.
- ``laplacian_diagonal`` bitwise equal to shm3d's.
- ``_kkt_matvec`` within 1e-12; ``_solve_kkt_minres`` on one b and one set
  of rows: u within 1e-9 and iterations within 5%.  The iterations are not
  held equal: MINRES on this saddle amplifies a rounding difference about
  3x an iteration until the iterates re-converge (shm3d against itself
  with b perturbed by 1e-15 relative: x apart by 5.6e-7 after 40
  iterations, 2.2e-4 after 44), so the two packages' summation orders move
  the stop (here 874 against 895 iterations at tol 1e-10).
- Whole solves: the icosphere at 16^3 within 1e-9 of shm3d's phi and 1e-7
  of the port's own projected CG; one float32 solve of a sphere cloud at
  refine_steps=1 in each package, its MINRES phi read as it enters the
  defect correction (both stop on phibar after some 2,400-2,700
  iterations, 2.3e-5 apart) and its corrected phi (8e-8 apart); the
  subsampled tier with its 1e-4 tolerance floor.
- On z-slabs of 4 and 8 CPU shards: ``_kkt_matvec`` bitwise equal to one
  device's; three iterations of ``_solve_kkt_minres`` within 1e-13.
- Device meshes of 4 and 8 CPU shards, 1-D and 2 x 2, given one Y: the
  shard-ordered dots round otherwise than one ``torch.dot``, so the
  iterations are held within 2 and u within 1e-9 of one device's; in
  float32 at 200 iterations, within 10x the change a rounding-size
  perturbation of Y makes.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from shm3d.ops import stencil as jstencil
from shm3d.solve import krylov as jkrylov
from shm3d.solve import projection as jproj
from shm3d.solvers import grid as jgrid
from shm3d_torch.api import SignedHeatSolver
from shm3d_torch.config import SignedHeatOptions
from shm3d_torch.domains import grid as griddom
from shm3d_torch.geometry.procedural import make_icosphere, make_sphere_cloud
from shm3d_torch.ops import stencil
from shm3d_torch.parallel import device_mesh
from shm3d_torch.parallel.shards import shard_rows
from shm3d_torch.solve import krylov, projection
from shm3d_torch.solvers import grid as tgrid
from shm3d_torch.utils.timing import PhaseTimer
from torch_interop import jax_geom, jax_options

torch.set_num_threads(2)

F64 = SignedHeatOptions(dtype="float64", solver_tol=1e-10, refine_steps=0,
                        disk_cache=False, solver_method="minres_kkt")


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _system(kind):
    """tests/test_device_grid.py's MINRES systems: (A, b, precond diagonal)."""
    if kind == "indefinite":
        rng = np.random.default_rng(6)
        B = rng.normal(size=(30, 30))
        A = (B + B.T) / 2 + np.diag(np.linspace(-5, 5, 30))
        return A, rng.normal(size=30), None
    rng = np.random.default_rng(7)
    B = rng.normal(size=(25, 25))
    A = (B + B.T) / 2 + np.diag(np.linspace(1, 50, 25))
    d = np.abs(np.diag(A)) + 1.0
    return A, rng.normal(size=25), d


@pytest.mark.parametrize("form", ["flat", "pair"])
@pytest.mark.parametrize("kind", ["indefinite", "spd_precond"])
def test_minres_matches_shm3d(kind, form):
    A, b, d = _system(kind)
    jA = jnp.asarray(A)
    jpre = None if d is None else (lambda r: r / jnp.asarray(d))
    want = jkrylov.minres(lambda x: jA @ x, jnp.asarray(b), precond=jpre, tol=1e-12,
                          maxiter=500)
    tA, td = torch.as_tensor(A), None if d is None else torch.as_tensor(d)
    k = 20  # the pair's split: 20 "nodes", the rest "multipliers"
    if form == "flat":
        matvec = lambda x: tA @ x
        pre = None if d is None else (lambda r: r / td)
        rhs, unpack = torch.as_tensor(b), lambda x: x
    else:
        join = lambda p: torch.cat([p.u, p.mu])
        split = lambda v: tgrid.KKTPair(v[:k], v[k:])
        matvec = lambda p: split(tA @ join(p))
        pre = None if d is None else (lambda p: tgrid.KKTPair(p.u / td[:k], p.mu / td[k:]))
        rhs, unpack = split(torch.as_tensor(b)), join
    got = krylov.minres(matvec, rhs, precond=pre, tol=1e-12, maxiter=500)
    x = unpack(got.x).numpy()
    assert got.iterations == int(want.iterations)
    assert _rel(x, np.asarray(want.x)) <= 1e-10
    # the final phibar is at the 1e-12 stop, where it is rounding noise:
    # held to 1e-10 of the starting residual's preconditioned norm
    ref = float(np.sqrt(b @ (b if d is None else b / d)))
    assert abs(got.residual - float(want.residual)) <= 1e-10 * ref
    np.testing.assert_allclose(x, np.linalg.solve(A, b), rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_laplacian_diagonal_matches_shm3d(dtype):
    got = stencil.laplacian_diagonal((5, 6, 7), 0.37, getattr(torch, dtype))
    want = np.asarray(jstencil.laplacian_diagonal((5, 6, 7), 0.37, getattr(jnp, dtype)))
    assert got.dtype == getattr(torch, dtype) and np.array_equal(got.numpy(), want)


@pytest.fixture(scope="module")
def rows16():
    """A 16^3 icosphere grid's constraint rows (float64) and A^T's table."""
    geom = make_icosphere(2)
    grid = griddom.build_grid(geom.vertices, 2.0, 0.0)
    nodes8, coeffs8 = griddom.constraint_rows(grid, tgrid.GridSolver._sources(geom).points)
    coeffs8 = np.asarray(coeffs8, np.float64)
    return (grid, nodes8, coeffs8, torch.as_tensor(nodes8, dtype=torch.int64),
            torch.as_tensor(coeffs8), projection.at_table(nodes8, coeffs8, "cpu", torch.float64))


def test_kkt_matvec_matches_shm3d(rows16):
    grid, nodes8, coeffs8, n8, c8, at = rows16
    rng = np.random.default_rng(21)
    u, mu = rng.standard_normal(grid.total_nodes), rng.standard_normal(nodes8.shape[0])
    want = np.asarray(jgrid._kkt_matvec(jnp.asarray(np.concatenate([u, mu])), jnp.asarray(nodes8),
                                        jnp.asarray(coeffs8), grid.cell_size, grid.shape))
    got = tgrid._kkt_matvec(tgrid.KKTPair(torch.as_tensor(u), torch.as_tensor(mu)),
                            n8, c8, at, grid.cell_size, grid.shape)
    got = np.concatenate([got.u.numpy(), got.mu.numpy()])
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


def test_solve_kkt_minres_matches_shm3d(rows16):
    grid, nodes8, coeffs8, n8, c8, at = rows16
    b = np.random.default_rng(0).standard_normal(grid.total_nodes)
    ju, jiters, jres = jgrid._solve_kkt_minres(jnp.asarray(b), jnp.asarray(nodes8),
                                               jnp.asarray(coeffs8), grid.cell_size,
                                               grid.shape, 1e-10, 10000)
    u, iters, res = tgrid._solve_kkt_minres(torch.as_tensor(b), n8, c8, at, grid.cell_size,
                                            grid.shape, 1e-10, 10000)
    assert abs(iters - jiters) <= 0.05 * jiters, (iters, jiters)
    assert _rel(u.numpy(), np.asarray(ju)) <= 1e-9
    # both stop on phibar <= 1e-10 of the same preconditioned rhs norm
    assert res <= float(jres) * 1.5 and float(jres) <= res * 1.5


def _slab_rows(rows16, mesh):
    """rows16's row gathers and A^T table cut for ``mesh``'s z-slabs."""
    grid, _, _, n8, _, at = rows16
    slab_len = grid.total_nodes // len(mesh)
    return projection.NodeGather(n8, mesh, slab_len), projection.SlabAt(at, mesh, slab_len)


@pytest.mark.parametrize("shards", [4, 8])
def test_kkt_matvec_on_slabs_bitwise(rows16, shards):
    """The KKT operator on z-slabs (slab stencil, row gathers, A^T per slab)
    gives one device's bits, u part and mu part."""
    grid, nodes8, _, n8, c8, at = rows16
    mesh = device_mesh(devices=["cpu"] * shards)
    rng = np.random.default_rng(22)
    u, mu = torch.as_tensor(rng.standard_normal(grid.total_nodes)), torch.as_tensor(
        rng.standard_normal(nodes8.shape[0]))
    want = tgrid._kkt_matvec(tgrid.KKTPair(u, mu), n8, c8, at, grid.cell_size, grid.shape)
    rows, slab_at = _slab_rows(rows16, mesh)
    got = tgrid._kkt_matvec(tgrid.KKTPair(shard_rows(u, mesh), mu), rows, c8, slab_at,
                            grid.cell_size, grid.shape)
    assert torch.equal(got.u.gather(), want.u) and torch.equal(got.mu, want.mu)


@pytest.mark.parametrize("shards,n_slices", [(4, 1), (8, 1), (4, 2)])
def test_solve_kkt_minres_on_slabs_first_iterations(rows16, shards, n_slices):
    """Three MINRES iterations on z-slabs (the sharded Schur diagonal, the
    slab V-cycle, the pair's shard-ordered dots) against one device's: the
    dots round otherwise than one torch.dot, so u within 1e-13, not bitwise."""
    grid, _, _, n8, c8, at = rows16
    mesh = device_mesh(devices=["cpu"] * shards, n_slices=n_slices)
    b = torch.as_tensor(np.random.default_rng(0).standard_normal(grid.total_nodes))
    u, iters, res = tgrid._solve_kkt_minres(b, n8, c8, at, grid.cell_size, grid.shape,
                                            1e-10, 3)
    rows, slab_at = _slab_rows(rows16, mesh)
    us, iters_s, res_s = tgrid._solve_kkt_minres(shard_rows(b, mesh), rows, c8, slab_at,
                                                 grid.cell_size, grid.shape, 1e-10, 3)
    assert iters == iters_s == 3
    assert _rel(us.gather().numpy(), u.numpy()) <= 1e-13
    assert abs(res_s - res) <= 1e-13 * res


@pytest.fixture(scope="module")
def one_device16():
    """The 16^3 icosphere solved on one device: (solver, result, its cache entry)."""
    s1 = tgrid.GridSolver(device="cpu")
    res = s1.compute_distance(make_icosphere(2), F64)
    return s1, res, next(iter(s1._cache.values()))


def test_grid_minres_kkt_matches_shm3d_f64(one_device16):
    """The whole 16^3 solve: phi within 1e-9 of shm3d's, and within 1e-7 of
    the port's projected CG (shm3d's own bar between the two methods,
    tests/test_device_grid.py)."""
    ts, res, _ = one_device16
    js = jgrid.GridSolver()
    want = js.compute_distance(jax_geom(make_icosphere(2)), jax_options(F64)).phi
    got = res.phi
    st = dict(ts.last_stats)
    assert (st["step3_path"], st["tier"]) == ("minres-kkt", "bmat")
    assert abs(st["iters"] - js.last_stats["iters"]) <= 0.05 * js.last_stats["iters"]
    # both record the final phibar, absolute, near 1e-10 of the same rhs norm
    assert 0.2 < st["rel_res"] / js.last_stats["rel_res"] < 5
    assert _rel(got, np.asarray(want)) <= 1e-9
    pcg_solver = tgrid.GridSolver(device="cpu")
    pcg = pcg_solver.compute_distance(make_icosphere(2), F64.with_(solver_method="projected_cg")).phi
    assert pcg_solver.last_stats["step3_path"] == "projected-mg-pcg"
    assert _rel(got, pcg) <= 1e-7


@pytest.fixture(scope="module")
def f32_cloud():
    """float32 at 16^3 on a sphere cloud at refine_steps=1, in both
    packages: {0: the MINRES solution as it enters the defect correction
    (the phi of a refine_steps=0 solve, which takes the same Step 3 from the
    same Y), 1: the corrected phi}, each (shm3d's phi, its stats, the port's
    phi, its stats)."""
    geom = make_sphere_cloud(2000)
    opts = SignedHeatOptions(dtype="float32", h_coef=0.0, refine_steps=1,
                             disk_cache=False, solver_method="minres_kkt")
    phis, stats = {}, {}
    for pkg, solver, g, o in (("shm3d", jgrid.GridSolver(), jax_geom(geom), jax_options(opts)),
                              ("port", tgrid.GridSolver(device="cpu"), geom, opts)):
        entering = []
        refine = solver._refine
        shift = jgrid._mean_shift if pkg == "shm3d" else tgrid._mean_shift

        def spy(u, Y, cached, *args, **kwargs):
            entering.append(np.asarray(shift(-u, cached["src_nodes8"], cached["src_coeffs8"],
                                             cached["weights"]), np.float64))
            return refine(u, Y, cached, *args, **kwargs)

        solver._refine = spy
        phi1 = np.asarray(solver.compute_distance(g, o).phi, np.float64)
        phis[pkg], stats[pkg] = (entering[0], phi1), dict(solver.last_stats)
        assert len(entering) == 1
    return {rs: (phis["shm3d"][rs], stats["shm3d"], phis["port"][rs], stats["port"])
            for rs in (0, 1)}


def test_grid_minres_kkt_f32_matches_shm3d(f32_cloud):
    """Both float32 solves stop on phibar after 2,424 (port) and 2,659
    (shm3d) iterations, phi 2.3e-5 apart: held within 15% and 1e-4."""
    want, jst, got, st = f32_cloud[0]
    assert st["step3_path"] == "minres-kkt"
    assert abs(st["iters"] - jst["iters"]) <= 0.15 * jst["iters"]
    assert st["iters"] < 10000  # stopped on phibar, not on solver_maxiter
    assert _rel(got, want) <= 1e-4


def test_grid_minres_kkt_refined_matches_shm3d(f32_cloud):
    """refine_steps=1 after MINRES: the f64 defect correction reaches
    refine_target in both packages (port 2.0e-11, shm3d 4.4e-11), phi 8e-8
    apart."""
    want, jst, got, st = f32_cloud[1]
    assert st["step3_path"] == "minres-kkt" and st["correction_iters"]
    assert st["refine_rel_res"] <= 1e-9 and jst["refine_rel_res"] <= 1e-9
    assert _rel(got, want) <= 1e-6


def test_grid_minres_kkt_subsampled_tier(monkeypatch):
    """Caps patched low in both packages: the device solve pins the
    subsample, and with solver_tol=None the tier's 1e-4 floor is the MINRES
    tolerance, as in shm3d."""
    for mod in (jproj, projection):
        monkeypatch.setattr(mod, "ORTHO_GRAM_CAP", 0)
        monkeypatch.setattr(mod, "TFORM_FULL_CAP", 0)
    tols = []
    solve = tgrid._solve_kkt_minres

    def spy(*args):
        tols.append(args[6])
        return solve(*args)

    monkeypatch.setattr(tgrid, "_solve_kkt_minres", spy)
    geom = make_icosphere(2)
    opts = SignedHeatOptions(dtype="float32", refine_steps=0, disk_cache=False,
                             max_device_pins=24, solver_method="minres_kkt")
    js = jgrid.GridSolver()
    want = np.asarray(js.compute_distance(jax_geom(geom), jax_options(opts)).phi)
    ts = tgrid.GridSolver(device="cpu")
    got = ts.compute_distance(geom, opts).phi
    assert tols == [1e-4]
    assert (ts.last_stats["step3_path"], ts.last_stats["tier"]) == ("minres-kkt", "subsampled")
    assert abs(ts.last_stats["iters"] - js.last_stats["iters"]) <= 0.15 * js.last_stats["iters"]
    assert _rel(got, want) <= 1e-3


@pytest.mark.parametrize("shards,n_slices", [(4, 1), (8, 1), (4, 2)])
def test_minres_kkt_on_mesh_given_one_y(one_device16, shards, n_slices):
    s1, res, cached = one_device16
    mesh = device_mesh(devices=["cpu"] * shards, n_slices=n_slices)
    sm = tgrid.GridSolver(mesh=mesh)
    cached.pop("slab_tables", None)
    grid = cached["grid"]
    u = sm._integrate_exact(shard_rows(res.Y, mesh), sm._slab_tables(cached, grid), grid,
                            True, F64.solver_tol, F64, PhaseTimer(torch.device("cpu")))
    assert sm.last_stats["step3_path"] == "minres-kkt"
    assert abs(sm.last_stats["iters"] - s1.last_stats["iters"]) <= 2
    assert _rel(u.gather().numpy(), res.u_device.numpy()) <= 1e-9


def test_minres_kkt_on_mesh_end_to_end(one_device16):
    """SignedHeatSolver("grid", mesh=) on 4 shards (the ring's Step 1, z-slab
    MINRES) against one device."""
    _, res, _ = one_device16
    solver = SignedHeatSolver("grid", mesh=device_mesh(devices=["cpu"] * 4))
    got = solver.compute_distance(make_icosphere(2), F64).phi
    st = solver.last_stats
    assert st["step3_path"] == "minres-kkt" and st["mesh"]["step3"] == "z-slabs"
    assert _rel(got, res.phi) <= 1e-9


def test_minres_kkt_mesh_at_200_iterations_within_rounding():
    """float32 stopped at 200 iterations, far from convergence, where MINRES
    still amplifies rounding: 4 shards given one Y move u no further than
    10x what a rounding-size change of Y (2^-23 relative) moves it on one
    device (measured 0.3-1.3x at 16^3 and 32^3).  chip_smoke.py's phase 19
    holds the card's 128^3 mesh solve to this rule."""
    geom = make_sphere_cloud(2000)
    opts = SignedHeatOptions(dtype="float32", h_coef=0.0, refine_steps=0, disk_cache=False,
                             solver_method="minres_kkt", solver_maxiter=200)
    s1 = tgrid.GridSolver(device="cpu")
    res = s1.compute_distance(geom, opts)
    cached = next(iter(s1._cache.values()))
    grid, tol, cpu = cached["grid"], opts.resolved_solver_tol(), torch.device("cpu")
    u1 = res.u_device.numpy()
    sens = []
    for seed in (0, 1):
        z = torch.as_tensor(np.random.default_rng(seed).standard_normal(tuple(res.Y.shape)),
                            dtype=res.Y.dtype)
        up = s1._integrate_exact(res.Y * (1 + 2.0 ** -23 * z), cached, grid, False, tol,
                                 opts, PhaseTimer(cpu))
        sens.append(_rel(up.numpy(), u1))
    mesh = device_mesh(devices=["cpu"] * 4)
    sm = tgrid.GridSolver(mesh=mesh)
    u = sm._integrate_exact(shard_rows(res.Y, mesh), sm._slab_tables(cached, grid), grid, False,
                            tol, opts, PhaseTimer(cpu))
    assert s1.last_stats["iters"] == sm.last_stats["iters"] == 200
    assert 0 < _rel(u.gather().numpy(), u1) <= 10 * max(sens)


@pytest.mark.cuda
def test_cuda_minres_kkt_matches_cpu(one_device16):
    """Step 3 in float64 on the card, given the CPU solve's Y (so that only
    Step 3's summation order differs), against the CPU's u."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    s1, res, cached = one_device16
    arrays = s1._build_host_arrays(make_icosphere(2), F64)
    sc = tgrid.GridSolver(device="cuda")
    dev_cached = tgrid.cached_from_arrays(arrays, sc.device, torch.float64)
    u = sc._integrate_exact(res.Y.to(sc.device), dev_cached, dev_cached["grid"], True,
                            F64.solver_tol, F64, PhaseTimer(sc.device))
    torch.cuda.synchronize()
    assert sc.last_stats["step3_path"] == "minres-kkt"
    assert abs(sc.last_stats["iters"] - s1.last_stats["iters"]) <= 0.05 * s1.last_stats["iters"]
    assert _rel(u.cpu().numpy(), res.u_device.numpy()) <= 1e-9
