"""The Krylov loops as setup, in-place iteration body and stop test
(``shm3d_torch.solve.krylov.cg_run`` / ``minres_run``) and their CUDA graphs
(``shm3d_torch.solve.graphs``).

On the CPU the setup and the bodies run through ``InPlace``, the stand-in
for a ``ChunkGraph`` (``tests/torch_chunks.py``), kept in the same caches
as the graphs are:

- on small dense systems, ``cg_run`` and ``minres_run`` give ``cg``'s and
  ``minres``'s x, iterations and residual bit for bit (the same ops in the
  same order; the body only adds ``copy_`` into its state);
- through the solvers, bit for bit against the eager loop on: the grid's
  projected CG at 16^3 on the bmat and full-row tiers and the default
  tier's correction solves, MINRES on the KKT system at 16^3, the tet CR
  path on tests/data/bunny_dec.obj, and the vertex path's three modes on the
  icosphere; and the same cases against the JAX package's solves within
  the tolerances the other port tests hold them to (float64 grid 1e-8,
  iterations +-1; full-row float32 1e-4; the default tier 1e-7; MINRES
  1e-9, iterations within 5%; bunny_dec CR 1e-8; vertex 1e-8);
- the caches: a new geometry gets its own graphs, the same one reuses its
  graph; a tet artifact upgrade drops the vertex graphs it replaces; mesh
  solves and CPU vectors take the eager loop;
- the launch counters: a launch noted while a body is captured counts at
  every replay (a stand-in for the replay), and directly otherwise.

Marked ``cuda`` (skipped without a card): the graphs against the eager
loop bit for bit on the same paths, with equal K2 launch counts, and a body
that syncs with the host raising at capture without running eagerly.
"""

import contextlib
import os

import numpy as np
import pytest
import torch

from shm3d.solve import projection as jproj
from shm3d.solvers.grid import GridSolver as JaxGridSolver
from shm3d.tet.solver import SignedHeatTetSolver as JaxTetSolver
from shm3d_torch.config import LevelSetConstraint, SignedHeatOptions
from shm3d_torch.geometry.procedural import make_icosphere, make_sphere_cloud
from shm3d_torch.io.mesh_io import read_geometry
from shm3d_torch.ops import yukawa
from shm3d_torch.parallel import device_mesh
from shm3d_torch.parallel.shards import shard_rows
from shm3d_torch.solve import graphs, krylov, pell, projection
from shm3d_torch.solvers import grid as tgrid
from shm3d_torch.tet.solver import SignedHeatTetSolver
from torch_chunks import EmulatedChunks
from torch_interop import jax_geom, jax_options

torch.set_num_threads(2)

BUNNY = os.path.join(os.path.dirname(__file__), "data", "bunny_dec.obj")
F64 = SignedHeatOptions(dtype="float64", refine_steps=0, disk_cache=False)
TIGHT = dict(dtype="float64", solver_tol=1e-12, solver_maxiter=60000,
             refine_steps=0, disk_cache=False)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


class InPlace(EmulatedChunks):
    """A Krylov solve's setup and iteration bodies called in place on state
    buffers of their own, no capture, each only while the stop predicate
    holds: ``graphs.ChunkGraph``'s interface on the CPU
    (``tests/torch_chunks.py``)."""


def _stand_in(cache, key, b):
    """``graphs.runner`` for CPU vectors: the in-place bodies, kept in the
    cache as the graphs are on a card (None for z-slabs or no cache)."""
    if cache is None or not isinstance(getattr(b, "u", b), torch.Tensor):
        return None
    return graphs.Cached(cache, key, InPlace)


@contextlib.contextmanager
def in_place():
    saved = graphs.runner
    graphs.runner = _stand_in
    try:
        yield
    finally:
        graphs.runner = saved


@contextlib.contextmanager
def patched(pairs):
    """Set (module, name, value) triples for the block."""
    saved = [(m, n, getattr(m, n)) for m, n, _ in pairs]
    for m, n, v in pairs:
        setattr(m, n, v)
    try:
        yield
    finally:
        for m, n, v in saved:
            setattr(m, n, v)


# --- the loops on small systems ----------------------------------------------


def _spd(n, seed, dtype):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, n))
    A = A @ A.T + n * np.eye(n)
    return (torch.as_tensor(A, dtype=dtype), torch.as_tensor(rng.normal(size=n), dtype=dtype),
            torch.as_tensor(np.diag(A).copy(), dtype=dtype))


@pytest.mark.parametrize("case", ["f64", "f32_stall", "x0_maxiter", "converged_at_start"])
def test_cg_run_in_place_matches_cg_bitwise(case):
    dtype = torch.float32 if case == "f32_stall" else torch.float64
    A, b, d = _spd(40, 3, dtype)
    kw = dict(precond=lambda r: r / d, tol=1e-12, maxiter=500)
    if case == "f32_stall":
        kw.update(tol=1e-30, maxiter=10_000, stall_window=20)
    elif case == "x0_maxiter":
        kw.update(x0=torch.linalg.solve(A, b) * 0.5, maxiter=7, rhs_mnorm=3.0)
    elif case == "converged_at_start":
        kw.update(x0=torch.linalg.solve(A, b), tol=1e-2)
    want = krylov.cg(lambda x: A @ x, b, **kw)
    cache = {}
    got = krylov.cg_run(lambda x: A @ x, b, runner=graphs.Cached(cache, "k", InPlace),
                        **kw)
    assert (got.iterations, got.residual) == (want.iterations, want.residual)
    assert torch.equal(got.x, want.x)
    assert isinstance(cache["k"], InPlace)
    if case == "converged_at_start":
        assert got.iterations == 0
    if "x0" in kw:  # the caller's x0 is read, never written
        assert got.x is not kw["x0"]


@pytest.mark.parametrize("form", ["flat", "pair"])
@pytest.mark.parametrize("kind", ["indefinite", "spd_precond"])
def test_minres_run_in_place_matches_minres_bitwise(kind, form):
    """tests/test_torch_minres.py's two systems, on flat vectors and split
    as KKT pairs (u the first 20 rows, mu the rest)."""
    rng = np.random.default_rng(6 if kind == "indefinite" else 7)
    n = 30
    B = rng.normal(size=(n, n))
    lo, hi = (-5, 5) if kind == "indefinite" else (1, 50)
    A = torch.as_tensor((B + B.T) / 2 + np.diag(np.linspace(lo, hi, n)))
    b = torch.as_tensor(rng.normal(size=n))
    d = A.diagonal().abs() + 1.0

    def split(v):
        return v if form == "flat" else tgrid.KKTPair(v[:20].clone(), v[20:].clone())

    def join(p):
        return p if form == "flat" else torch.cat([p.u, p.mu])

    kw = dict(precond=None if kind == "indefinite" else (lambda r: split(join(r) / d)),
              tol=1e-10, maxiter=300)
    matvec = lambda x: split(A @ join(x))
    want = krylov.minres(matvec, split(b), **kw)
    cache = {}
    got = krylov.minres_run(matvec, split(b), runner=graphs.Cached(cache, "k", InPlace),
                            **kw)
    assert 0 < got.iterations < 300
    assert (got.iterations, got.residual) == (want.iterations, want.residual)
    assert torch.equal(join(got.x), join(want.x))
    assert len(cache["k"].bodies) == 2


# --- the solvers' paths: the in-place body against the eager loop and shm3d ---

CASES = ["grid_bmat_f64", "grid_full_row_f32", "grid_default_f32", "grid_minres_f64",
         "tet_cr_bunny", "vertex_zero_set", "vertex_none", "vertex_multiple"]


def _grid_case(case):
    """(port options, geometry, extra patches of both packages)."""
    if case == "grid_bmat_f64":
        return F64.with_(step1_method="dense"), make_icosphere(2), []
    if case == "grid_full_row_f32":
        return (SignedHeatOptions(dtype="float32", h_coef=0.0, refine_steps=0, disk_cache=False),
                make_sphere_cloud(2000),
                [(jproj, "ORTHO_GRAM_CAP", 0), (projection, "ORTHO_GRAM_CAP", 0)])
    if case == "grid_default_f32":
        return SignedHeatOptions(dtype="float32", disk_cache=False), make_icosphere(2), []
    return F64.with_(solver_tol=1e-10, solver_method="minres_kkt"), make_icosphere(2), []


@pytest.fixture(scope="module", params=CASES)
def solved(request):
    """One case: the port's eager solve, its solve with the in-place body
    on the same solver (cached discretization), and shm3d's solve, as
    (phi, stats) each, plus the port solver's graph caches."""
    case = request.param
    if case.startswith("grid"):
        opts, geom, patches = _grid_case(case)
        with patched(patches):
            ts = tgrid.GridSolver(device="cpu")
            eager = ts.compute_distance(geom, opts)
            est = dict(ts.last_stats)
            with in_place():
                stepped = ts.compute_distance(geom, opts)
            sst = dict(ts.last_stats)
            js = JaxGridSolver()
            jphi = js.compute_distance(jax_geom(geom), jax_options(opts)).phi
        caches = [next(iter(ts._cache.values()))["graphs"]]
        return case, (eager.phi, est), (stepped.phi, sst), (np.asarray(jphi), js.last_stats), caches
    if case == "tet_cr_bunny":
        geom, opts = read_geometry(BUNNY), SignedHeatOptions(dtype="float64", disk_cache=False)
    else:
        mode = LevelSetConstraint(case[len("vertex_"):])
        geom = make_icosphere(2)
        opts = SignedHeatOptions(level_set_constraint=mode, use_crouzeix_raviart=False, **TIGHT)
    ts = SignedHeatTetSolver(device="cpu")
    eager = ts.compute_distance(geom, opts)
    est = dict(ts.last_stats)
    with in_place():
        stepped = ts.compute_distance(geom, opts)
    sst = dict(ts.last_stats)
    js = JaxTetSolver()
    jres = js.compute_distance(jax_geom(geom), jax_options(opts))
    cached = next(iter(ts._cache.values()))
    caches = ([cached["cr_path"].graphs] if case == "tet_cr_bunny"
              else [cached["vertex_graphs"]])
    return case, (eager.phi, est), (stepped.phi, sst), (jres.phi, js.last_stats), caches


_STAT_KEYS = ("iters", "rel_res", "residual", "correction_iters", "refine_pass_rels",
              "refine_rel_res", "proj_iters", "proj_residual", "proj_refine_pass_rels")


def test_in_place_body_matches_eager_bitwise(solved):
    case, (ephi, est), (sphi, sst), _, caches = solved
    assert np.array_equal(sphi, ephi)
    for k in _STAT_KEYS:
        assert sst.get(k) == est.get(k), k
    assert est["step3_path"] == sst["step3_path"]
    steppers = [v for c in caches for v in c.values()]
    # the stepped solve went through the in-place bodies: one stepper a
    # solve kind (CR: the face and the projection solve)
    assert steppers and all(isinstance(s, InPlace) for s in steppers)
    assert len(steppers) == (2 if case == "tet_cr_bunny" else 1)
    if case == "grid_default_f32":
        assert len(sst["correction_iters"]) >= 1


def test_in_place_body_matches_shm3d(solved):
    case, _, (phi, st), (jphi, jst), _ = solved
    assert np.isfinite(phi).all() and phi.shape == jphi.shape
    if case in ("grid_bmat_f64",):
        assert _rel(phi, jphi) < 1e-8
        assert abs(st["iters"] - jst["iters"]) <= 1
    elif case == "grid_full_row_f32":
        assert st["tier"] == "full-row"
        assert _rel(phi, jphi) < 1e-4
    elif case == "grid_default_f32":
        assert _rel(phi, jphi) <= 1e-7
    elif case == "grid_minres_f64":
        assert st["step3_path"] == "minres-kkt"
        assert abs(st["iters"] - jst["iters"]) <= 0.05 * jst["iters"]
        assert _rel(phi, jphi) <= 1e-9
    else:
        assert st["step3_path"] == jst["step3_path"]
        assert _rel(phi, jphi) <= 1e-8


# --- the caches -------------------------------------------------------------


def test_runner_takes_the_eager_loop_off_one_cuda_device():
    v = torch.zeros(64)
    mesh = device_mesh(devices=["cpu"] * 2)
    assert graphs.runner({}, "k", v) is None
    assert graphs.runner({}, "k", tgrid.KKTPair(v, torch.zeros(3))) is None
    assert graphs.runner({}, "k", shard_rows(v, mesh)) is None
    assert graphs.runner(None, "k", v) is None
    assert not graphs.one_cuda_vector(shard_rows(v, mesh))


def test_grid_graph_cache_rekeys_on_new_geometry():
    opts = SignedHeatOptions(dtype="float32", refine_steps=0, disk_cache=False)
    ts = tgrid.GridSolver(device="cpu")
    a, b = make_icosphere(2), make_sphere_cloud(800)
    with in_place():
        first = ts.compute_distance(a, opts).phi
        (key_a, cached_a), = ts._cache.items()
        stepper = cached_a["graphs"][("projected-cg", cached_a["grid"].shape, torch.float32)]
        ts.compute_distance(b, opts)
        cached_b = next(v for k, v in ts._cache.items() if k != key_a)
        assert cached_b["graphs"] is not cached_a["graphs"]
        (other,) = cached_b["graphs"].values()
        assert other is not stepper
        again = ts.compute_distance(a, opts).phi
    assert cached_a["graphs"][("projected-cg", cached_a["grid"].shape, torch.float32)] is stepper
    assert np.array_equal(again, first)


def test_tet_artifact_upgrade_drops_vertex_graphs():
    ico = make_icosphere(2)
    base = SignedHeatOptions(dtype="float64", refine_steps=0, disk_cache=False,
                             solver_tol=1e-8)
    ts = SignedHeatTetSolver(device="cpu")
    with in_place():
        ts.compute_distance(ico, base)   # CR: the artifact holds no vertex operators
        cached = next(iter(ts._cache.values()))
        assert "H_ell" not in cached and set(cached["cr_path"].graphs) == {
            ("face", LevelSetConstraint.ZERO_SET), "projection"}
        stale = object()
        cached["vertex_graphs"] = {(LevelSetConstraint.ZERO_SET, torch.float64): stale}
        ts.compute_distance(ico, base.with_(use_crouzeix_raviart=False))  # the upgrade
        (fresh,) = cached["vertex_graphs"].values()
        assert fresh is not stale and isinstance(fresh, InPlace)
        # a greedy-keyed artifact upgraded to CR builds a CR path with its
        # own, empty graph cache
        tg = SignedHeatTetSolver(device="cpu")
        tg.compute_distance(ico, base.with_(fast_integration=True))
        cg = next(iter(tg._cache.values()))
        assert cg["cr_path"] is None
        tg.compute_distance(ico, base)
        assert set(cg["cr_path"].graphs) == {("face", LevelSetConstraint.ZERO_SET),
                                             "projection"}


def test_mesh_cr_path_keeps_no_graphs():
    ico = make_icosphere(2)
    mesh = device_mesh(devices=["cpu"] * 2)
    ts = SignedHeatTetSolver(mesh=mesh)
    opts = SignedHeatOptions(dtype="float64", refine_steps=0, disk_cache=False,
                             solver_tol=1e-6)
    with in_place():
        ts.compute_distance(ico, opts)
        ts.compute_distance(ico, opts.with_(use_crouzeix_raviart=False))
    cached = next(iter(ts._cache.values()))
    assert cached["cr_path"].graphs is None
    assert "vertex_graphs" not in cached


# --- the launch counters ----------------------------------------------------


def test_counters_count_each_replay_of_a_capture():
    k2, k1, k1_64 = pell.KERNEL_LAUNCHES, yukawa.KERNEL_LAUNCHES, yukawa.MERGE_LAUNCHES_F64
    counts = graphs.LaunchCounts()
    with counts.recording():   # the stand-in capture: the wrappers' counting
        pell._count_launch()
        pell._count_launch()
        yukawa._count("KERNEL_LAUNCHES")
        yukawa._count("MERGE_LAUNCHES_F64")
    assert (pell.KERNEL_LAUNCHES, yukawa.KERNEL_LAUNCHES, yukawa.MERGE_LAUNCHES_F64) == \
        (k2, k1, k1_64)
    for _ in range(3):         # the stand-in replays
        counts.add()
    assert pell.KERNEL_LAUNCHES == k2 + 6
    assert yukawa.KERNEL_LAUNCHES == k1 + 3 and yukawa.MERGE_LAUNCHES_F64 == k1_64 + 3
    pell._count_launch()       # outside a capture: counted at once
    yukawa._count("PARTIAL_LAUNCHES")
    assert pell.KERNEL_LAUNCHES == k2 + 7
    assert not graphs.note_launch(pell.__name__, "KERNEL_LAUNCHES")


# --- on the card -------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    from shm3d_torch._device import resolve_device

    return resolve_device("cuda")


@contextlib.contextmanager
def eager_loops():
    with patched([(graphs, "runner", lambda *args, **kw: None),
                  (graphs, "stage_runner", lambda *args, **kw: None)]):
        yield


CUDA_CASES = ["grid_bmat_f64", "grid_full_row_f32", "grid_default_f32", "grid_minres_f32",
              "tet_cr_bunny_f32", "vertex_zero_set_f32", "vertex_none_f32",
              "vertex_multiple_f32"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CUDA_CASES)
def test_cuda_graph_matches_eager_bitwise(cuda_device, case):
    """Warm solves: one through the eager loop, two through the graphs
    (the first captures), bit for bit, with the same K2 launches."""
    if case.startswith("grid"):
        opts, geom, patches = _grid_case(case.replace("minres_f32", "minres_f64"))
        if case == "grid_minres_f32":
            opts = opts.with_(dtype="float32", solver_maxiter=300)
        solver = tgrid.GridSolver(device=cuda_device)
    else:
        patches = []
        if case == "tet_cr_bunny_f32":
            geom, opts = read_geometry(BUNNY), SignedHeatOptions(disk_cache=False)
        else:
            geom = make_icosphere(2)
            opts = SignedHeatOptions(level_set_constraint=LevelSetConstraint(case[7:-4]),
                                     use_crouzeix_raviart=False, disk_cache=False)
        solver = SignedHeatTetSolver(device=cuda_device)
    runs = []
    with patched(patches):
        solver.compute_distance(geom, opts)
        for mode in ("eager", "graph", "graph"):
            with eager_loops() if mode == "eager" else contextlib.nullcontext():
                k2 = pell.KERNEL_LAUNCHES
                res = solver.compute_distance(geom, opts)
                torch.cuda.synchronize()
                runs.append((res.phi, {k: solver.last_stats.get(k) for k in _STAT_KEYS},
                             pell.KERNEL_LAUNCHES - k2))
    (ephi, est, ek2), (gphi, gst, _), (gphi2, gst2, gk2) = runs
    assert np.array_equal(gphi, ephi) and np.array_equal(gphi2, ephi)
    assert gst == est and gst2 == est
    assert gk2 == ek2
    if case.startswith("vertex"):
        assert ek2 > 0  # float32 H is a SellMat: K2 inside the graphs


@pytest.mark.cuda
def test_cuda_capture_of_a_host_sync_raises(cuda_device):
    A, b, d = _spd(64, 4, torch.float32)
    A, b, d = A.to(cuda_device), b.to(cuda_device), d.to(cuda_device)
    calls = []

    def matvec(x):
        calls.append(float(x.sum()))   # a host sync inside the body
        return A @ x

    cache = {}
    with pytest.raises(RuntimeError, match="aten"):
        krylov.cg_run(matvec, b, precond=lambda r: r / d, tol=1e-10, maxiter=50,
                      runner=graphs.runner(cache, "k", b))
    assert cache == {}
    assert calls == []  # the setup runs under the sync check too: it raised there
