"""The Krylov solves as device programs (``shm3d_torch.solve.graphs``
``ChunkGraph``: a setup graph and the loop under a WHILE node that runs to
the stop, MINRES's iteration 0 under an IF node before it, the stop test on
the device, ``shm3d_torch.solve.stop``) and the stage graphs of the grid
path.

On the CPU:

- the plain versions of the stop test (``cg_stop_torch``,
  ``minres_stop_torch``) against the eager loops' Python test, over
  sequences of r.z, phibar and beta that cover the stall window, maxiter,
  zeros, NaN and inf: the same rn, best, since and k after every
  iteration, and the same stop iteration; the start's rhs_mnorm and
  threshold equal the host's floats bit for bit;
- ``tests/torch_chunks.py``'s stand-in for ``ChunkGraph`` (each body only
  while the predicate holds, the start condition from the plain version of
  the start kernel) against the eager loops bit for bit (x or phi,
  iterations, residuals, one host read a solve), through the grid solver
  at 16^3 (float32 and float64, the default tier's correction solves,
  MINRES on the KKT system) and the tet vertex path on the icosphere, run
  to the stop and cut at 7 and 1 iterations; MINRES and CG cut at 0, 1
  and 2 iterations (a solve stopped in its setup runs no iteration; MINRES
  at 1 runs its iteration 0 alone);
- the port's projected CG on the setup and chunks against shm3d's
  ``_pinned_pcg_chunk`` on the same discretization and right-hand side
  (float64, JAX x64 on the CPU): equal iterations, u within 1e-8;
- the launch counters: a chunk adds the launches of the bodies that ran;
- CPU tensors, z-slabs and a device mesh take the eager loops and stages
  by their device type; the kernel's wrapper raises on CPU tensors.

Marked ``cuda`` (skipped without a card): the stop kernel and the start
kernel against their plain versions bit for bit, and ``ChunkGraph``
against the eager loop with its conditional nodes counted and its K2
launches equal.
"""

import contextlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from shm3d.solvers import grid as jgrid
from shm3d.solvers.grid import GridSolver as JaxGridSolver
from shm3d_torch.config import LevelSetConstraint, SignedHeatOptions
from shm3d_torch.geometry.procedural import make_icosphere
from shm3d_torch.parallel import device_mesh
from shm3d_torch.parallel.shards import shard_rows
from shm3d_torch.solve import ell, graphs, krylov, pell, stop
from shm3d_torch.solvers import grid as tgrid
from shm3d_torch.tet.solver import SignedHeatTetSolver
from torch_chunks import EmulatedChunks

torch.set_num_threads(2)

F32_ANY = st.floats(width=32, allow_nan=True, allow_infinity=True)
F64_ANY = st.floats(allow_nan=True, allow_infinity=True)
POS = st.floats(min_value=1e-12, max_value=1e6)


def _same(a: float, b: float) -> bool:
    return a == b or (math.isnan(a) and math.isnan(b))


# --- the stop test: plain version against the eager loops' Python test -------


def _host_cg(rz0, rzs, tol, maxiter, window, rhs, tiny):
    """``krylov.cg``'s host test over the r.z values: the threshold, then
    (rn, best, since, k) after each iteration taken."""
    threshold = tol * max(rhs, tiny)
    rn = math.sqrt(abs(rz0))
    best, since, k = rn, 0, 0
    trace = [(rn, best, since, k)]
    for rz in rzs:
        if not (rn > threshold and k < maxiter and since < window):
            break
        rn = math.sqrt(abs(rz))
        since = 0 if rn < 0.98 * best else since + 1
        best = min(best, rn)
        k += 1
        trace.append((rn, best, since, k))
    return threshold, trace


def _device_cg(rz0, rzs, tol, maxiter, window, bmb, dtype):
    """The same through ``cg_stop_torch`` on 0-dim tensors: start, then one
    call an iteration while the predicate holds."""
    s, go = stop.new_state("cpu")
    s[:5] = stop.params(tol, maxiter, window, torch.finfo(dtype).tiny)
    t = lambda v: torch.tensor(v, dtype=dtype)
    stop.cg_stop_torch(t(rz0), t(bmb), s, go, start=True)
    trace = [tuple(s[stop.RN:stop.K + 1].tolist())]
    for rz in rzs:
        if not bool(go):
            break
        stop.cg_stop_torch(t(rz), None, s, go, start=False)
        trace.append(tuple(s[stop.RN:stop.K + 1].tolist()))
    assert bool(go) == bool(s[stop.GO])
    return s, trace


@settings(max_examples=150, deadline=None)
@given(dtype=st.sampled_from([torch.float32, torch.float64]), data=st.data(),
       tol=POS, maxiter=st.integers(0, 40), window=st.integers(1, 8))
def test_cg_stop_plain_matches_host_test(dtype, data, tol, maxiter, window):
    floats = F32_ANY if dtype == torch.float32 else F64_ANY
    # mostly shrinking residuals with plateaus (the stall window), plus
    # zeros, NaN and inf from the float strategy
    rz0 = data.draw(floats)
    rzs = data.draw(st.lists(st.one_of(floats, st.sampled_from([0.0, 1.0, 0.5, 0.49])),
                             max_size=45))
    bmb = data.draw(floats)
    as_dtype = lambda v: float(torch.tensor(v, dtype=dtype))
    rz0, bmb, rzs = as_dtype(rz0), as_dtype(bmb), [as_dtype(v) for v in rzs]
    rhs = math.sqrt(abs(bmb))
    thr, want = _host_cg(rz0, rzs, tol, maxiter, window, rhs, torch.finfo(dtype).tiny)
    s, got = _device_cg(rz0, rzs, tol, maxiter, window, bmb, dtype)
    assert _same(s[stop.RHS].item(), rhs) and _same(s[stop.THR].item(), thr)
    assert len(got) == len(want)  # the same stop iteration
    for g, w in zip(got, want):
        assert all(_same(a, float(b)) for a, b in zip(g, w)), (g, w)


def _host_minres(phibars, betas, tol, maxiter, ref, dtype):
    """``krylov.minres``'s host test: the threshold, and the iterations
    taken when (phibar, beta) read before the first and after each
    iteration are these values."""
    threshold = float(tol * torch.clamp_min(torch.tensor(ref, dtype=dtype),
                                            torch.finfo(dtype).tiny))
    k = 0
    for pb, bt in zip(phibars[:-1], betas[:-1]):
        if not (pb > threshold and k < maxiter and bt > 0):
            break
        k += 1
    return threshold, k


@settings(max_examples=150, deadline=None)
@given(dtype=st.sampled_from([torch.float32, torch.float64]), data=st.data(),
       tol=POS, maxiter=st.integers(0, 30))
def test_minres_stop_plain_matches_host_test(dtype, data, tol, maxiter):
    floats = F32_ANY if dtype == torch.float32 else F64_ANY
    n = data.draw(st.integers(1, 35))
    phibars = data.draw(st.lists(st.one_of(floats, st.sampled_from([0.0, 1e-3, 1.0])),
                                 min_size=n, max_size=n))
    betas = data.draw(st.lists(st.one_of(floats, st.sampled_from([0.0, -0.0, 1.0])),
                               min_size=n, max_size=n))
    ref = data.draw(floats)
    t = lambda v: torch.tensor(v, dtype=dtype)
    phibars = [float(t(v)) for v in phibars]
    betas = [float(t(v)) for v in betas]
    thr, k_want = _host_minres(phibars, betas, tol, maxiter, float(t(ref)), dtype)
    s, go = stop.new_state("cpu")
    s[:5] = stop.params(tol, maxiter, 0, torch.finfo(dtype).tiny)
    stop.minres_stop_torch(t(phibars[0]), t(betas[0]), t(ref), s, go, start=True)
    assert _same(s[stop.THR].item(), thr)
    for pb, bt in zip(phibars[1:], betas[1:]):
        if not bool(go):
            break
        stop.minres_stop_torch(t(pb), t(bt), None, s, go, start=False)
        assert _same(s[stop.RN].item(), pb) and _same(s[stop.BEST].item(), bt)
    # the host test reads (phibar, beta) of iteration k before iteration k+1
    assert int(s[stop.K]) == k_want


@settings(max_examples=200, deadline=None)
@given(dtype=st.sampled_from([torch.float32, torch.float64]), data=st.data(), tol=POS)
def test_device_rhs_mnorm_and_threshold_are_the_hosts(dtype, data, tol):
    """CG: rhs_mnorm = sqrt(|b . M b|) and tol * max(rhs_mnorm, tiny) in
    float64; MINRES: float(tol * clamp_min(ref, tiny)) in the dtype."""
    floats = F32_ANY if dtype == torch.float32 else F64_ANY
    bmb, ref = data.draw(floats), data.draw(floats)
    t = lambda v: torch.tensor(v, dtype=dtype)
    tiny = torch.finfo(dtype).tiny
    s, go = stop.new_state("cpu")
    s[:5] = stop.params(tol, 10, 11, tiny)
    stop.cg_stop_torch(t(1.0), t(bmb), s, go, start=True)
    rhs = math.sqrt(abs(float(t(bmb))))
    assert _same(s[stop.RHS].item(), rhs)
    assert _same(s[stop.THR].item(), tol * max(rhs, tiny))
    stop.minres_stop_torch(t(1.0), t(1.0), t(ref), s, go, start=True)
    assert _same(s[stop.THR].item(), float(tol * torch.clamp_min(t(ref), tiny)))


# --- the stand-in against the eager loops ------------------------------------


@contextlib.contextmanager
def chunked():
    """``graphs.runner`` replaced by the stand-in, kept in the caches as the
    graphs are on a card (None for z-slabs or no cache, as there)."""
    saved = graphs.runner

    def run(cache, key, b):
        if cache is None or not isinstance(getattr(b, "u", b), torch.Tensor):
            return None
        return graphs.Cached(cache, key, EmulatedChunks)

    graphs.runner = run
    try:
        yield
    finally:
        graphs.runner = saved


GRID_CASES = {
    "f32_fast": SignedHeatOptions(dtype="float32", refine_steps=0, disk_cache=False),
    "f64": SignedHeatOptions(dtype="float64", refine_steps=0, disk_cache=False,
                             solver_tol=1e-10),
    "f32_default": SignedHeatOptions(dtype="float32", disk_cache=False),
    "f64_minres": SignedHeatOptions(dtype="float64", refine_steps=0, disk_cache=False,
                                    solver_tol=1e-8, solver_method="minres_kkt"),
}
# solver_maxiter: the solve runs to its stop test, or is cut by maxiter
CAPS = {"to the stop": None, "cut at 7": 7, "cut at 1": 1}
_KEYS = ("iters", "rel_res", "correction_iters", "refine_pass_rels", "refine_rel_res",
         "residual")


def _capped(opts, cap):
    return opts if cap is None else opts.with_(solver_maxiter=cap)


@pytest.fixture(scope="module")
def grid_eager():
    geom = make_icosphere(2)
    out = {}
    for name, opts in GRID_CASES.items():
        for cap_name, cap in CAPS.items():
            solver = tgrid.GridSolver(device="cpu")
            res = solver.compute_distance(geom, _capped(opts, cap))
            out[name, cap_name] = (solver, geom, res.phi,
                                   {k: solver.last_stats.get(k) for k in _KEYS})
    return out


@pytest.mark.parametrize("cap", list(CAPS))
@pytest.mark.parametrize("case", list(GRID_CASES))
def test_chunks_match_eager_grid(grid_eager, case, cap):
    solver, geom, phi, stats = grid_eager[case, cap]
    (cached,) = solver._cache.values()
    cached.pop("graphs", None)
    with chunked():
        for _ in range(2):  # the first builds the stand-in, the second reuses it
            res = solver.compute_distance(geom, _capped(GRID_CASES[case], CAPS[cap]))
            assert np.array_equal(res.phi, phi)
            assert {key: solver.last_stats.get(key) for key in _KEYS} == stats
    (stepper,) = [v for v in cached["graphs"].values() if isinstance(v, EmulatedChunks)]
    # one host read a Krylov solve: the primary and each correction solve
    assert stepper.reads == 2 * (1 + len(stats["correction_iters"] or []))


def test_grid_caps_stop_where_asked(grid_eager):
    """The cases above stop on their tolerance within the default cap, and
    at the cap when it is 7 or 1."""
    for case in GRID_CASES:
        assert 7 < grid_eager[case, "to the stop"][3]["iters"] < 2000
        assert grid_eager[case, "cut at 7"][3]["iters"] == 7
        assert grid_eager[case, "cut at 1"][3]["iters"] == 1


@pytest.mark.parametrize("cap", list(CAPS))
def test_chunks_match_eager_tet_vertex(cap):
    geom = make_icosphere(2)
    opts = _capped(SignedHeatOptions(level_set_constraint=LevelSetConstraint.ZERO_SET,
                                     use_crouzeix_raviart=False, dtype="float64",
                                     solver_tol=1e-10, refine_steps=0, disk_cache=False),
                   CAPS[cap])
    solver = SignedHeatTetSolver(device="cpu")
    want = solver.compute_distance(geom, opts).phi
    wst = dict(solver.last_stats)
    with chunked():
        got = solver.compute_distance(geom, opts).phi
    gst = solver.last_stats
    assert np.array_equal(got, want)
    assert (gst["iters"], gst["rel_res"]) == (wst["iters"], wst["rel_res"])
    assert CAPS[cap] is None or wst["iters"] == CAPS[cap]
    cached = next(iter(solver._cache.values()))
    (stepper,) = cached["vertex_graphs"].values()
    assert isinstance(stepper, EmulatedChunks) and stepper.reads == 1


# --- the stages ------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_shell_plan_builds_the_interpolation_once(dtype):
    """``DeviceShellPlan`` builds W once (no accumulating index_put_ inside a
    solve, and so inside its stage graph): W holds 1 - w and w at lo and
    lo + 1 of each row, the field against shm3d's (which builds W in every
    call) within the float32 tolerance of the other port tests."""
    from shm3d.ops import farfield as jfarfield
    from shm3d_torch.domains.grid import build_grid
    from shm3d_torch.ops import farfield

    geom = make_icosphere(2)
    src = tgrid.GridSolver._sources(geom)
    grid = build_grid(geom.vertices, 2.0, 1.0)
    lam = float(1.0 / grid.cell_size)
    plan = farfield.build_shell_plan(grid, src.points, lam, shell_t=4.0, factor=4)
    dplan = farfield.DeviceShellPlan(plan, "cpu", dtype)
    pts = torch.as_tensor(src.points, dtype=dtype)
    vecs = torch.as_tensor(src.vectors(), dtype=dtype)
    got = farfield.yukawa_field_shell(dplan, pts, vecs, lam, grid.n)
    W = torch.zeros((grid.n, dplan.m), dtype=dtype)
    rows = torch.arange(grid.n)
    W[rows, dplan.lo] = (1.0 - dplan.w).to(dtype)
    W[rows, dplan.lo + 1] = dplan.w.to(dtype)
    assert dplan.W.dtype == dtype and torch.equal(dplan.W, W)
    ref = np.asarray(jfarfield.yukawa_field_shell(
        jfarfield.ShellPlan.from_arrays(plan.arrays()), jnp.asarray(pts.numpy()),
        jnp.asarray(vecs.numpy()), lam, grid.n))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=5e-6)


# --- against shm3d -------------------------------------------------------------


def test_setup_and_chunks_match_shm3d_pinned_pcg_chunk():
    """One discretization (the port's host arrays, read by both packages),
    one random right-hand side, float64: the port's projected CG on the
    stand-in's setup and chunks against shm3d's ``_pinned_pcg_chunk``."""
    geom = make_icosphere(2)
    opts = SignedHeatOptions(dtype="float64", refine_steps=0, disk_cache=False)
    arrays = tgrid.GridSolver(device="cpu")._build_host_arrays(geom, opts)
    cached = tgrid.cached_from_arrays(arrays, torch.device("cpu"), torch.float64)
    js = JaxGridSolver()
    jc = js._cached_from_arrays(arrays, jnp.float64)
    grid = cached["grid"]
    shape, cell = grid.shape, float(grid.cell_size)
    b = np.random.default_rng(5).normal(size=grid.total_nodes)
    tol = 1e-10
    ju, jiters, jrel = jgrid._pinned_pcg_chunk(
        jnp.asarray(b), jnp.zeros_like(jnp.asarray(b)), jc["pin_nodes8"], jc["pin_coeffs8"],
        jc["gram"], cell, shape, tol, 500, js._pin_masks(jc, grid))
    cache = {}
    with chunked():
        u, iters, rel = tgrid._solve_pinned(
            torch.as_tensor(b), cached["pin_nodes8"], cached["pin_coeffs8"], cached["gram"],
            cached["pin_at"], cell, shape, tol, 500,
            pins=tgrid.GridSolver._pin_masks(cached, grid), graphs=cache)
    assert isinstance(next(iter(cache.values())), EmulatedChunks)
    assert iters == int(jiters)
    ju = np.asarray(ju)
    assert np.linalg.norm(u.numpy() - ju) <= 1e-8 * np.linalg.norm(ju)
    assert rel <= tol and float(jrel) <= tol


# --- launch counters, device types, no fallback --------------------------------


@pytest.mark.parametrize("maxiter", [200, 5, 1])
def test_chunk_counts_the_launches_of_the_bodies_that_ran(maxiter):
    """A matvec that counts one K2 launch: the eager loop's launches, and
    the stand-in's (a solve adds the noted launches of the bodies that ran;
    the cold solve also counts its warm-up iteration)."""
    rng = np.random.default_rng(8)
    A = rng.normal(size=(30, 30))
    A = torch.as_tensor(A @ A.T + 30 * np.eye(30))
    b = torch.as_tensor(rng.normal(size=30))

    def matvec(x):
        pell._count_launch()
        return A @ x

    kw = dict(tol=1e-12, maxiter=maxiter)
    before = pell.KERNEL_LAUNCHES
    want = krylov.cg(matvec, b, **kw)
    eager = pell.KERNEL_LAUNCHES - before
    assert eager == want.iterations + 1
    cache = {}
    counts = []
    for _ in range(2):
        before = pell.KERNEL_LAUNCHES
        got = krylov.cg_run(matvec, b, runner=graphs.Cached(cache, "k", EmulatedChunks), **kw)
        counts.append(pell.KERNEL_LAUNCHES - before)
        assert got.iterations == want.iterations and torch.equal(got.x, want.x)
    assert counts == [eager + 1, eager]
    assert want.iterations == min(maxiter, want.iterations) and cache["k"].reads == 2


@pytest.mark.parametrize("maxiter", [0, 1, 2, 300])
def test_minres_iteration0_and_loop_match_eager(maxiter):
    """MINRES on an indefinite system: its iteration 0 under the IF node and
    the rest in the loop give the eager loop's x, iterations and phibar bit
    for bit, cut at 0 (no iteration: the IF node's condition is false), 1
    (iteration 0 alone), 2, or run to the stop; K2 launches counted for the
    bodies that ran (one matvec an iteration, one in the setup).  CG cut at
    0 runs no iteration either."""
    rng = np.random.default_rng(21)
    B = rng.normal(size=(40, 40))
    A = torch.as_tensor((B + B.T) / 2 + np.diag(np.linspace(-4, 4, 40)))
    b = torch.as_tensor(rng.normal(size=40))

    def matvec(x):
        pell._count_launch()
        return A @ x

    before = pell.KERNEL_LAUNCHES
    want = krylov.minres(matvec, b, tol=1e-10, maxiter=maxiter)
    eager = pell.KERNEL_LAUNCHES - before
    assert want.iterations == (maxiter if maxiter < 300 else want.iterations) < 300
    cache, counts = {}, []
    for _ in range(2):
        before = pell.KERNEL_LAUNCHES
        got = krylov.minres_run(matvec, b, tol=1e-10, maxiter=maxiter,
                                runner=graphs.Cached(cache, "m", EmulatedChunks))
        counts.append(pell.KERNEL_LAUNCHES - before)
        assert (got.iterations, got.residual) == (want.iterations, want.residual)
        assert torch.equal(got.x, want.x)
    assert counts == [eager + 2, eager]  # the cold solve's two warm-up bodies
    got = krylov.cg_run(lambda x: A @ A @ x, b, tol=1e-10, maxiter=0,
                        runner=graphs.Cached(cache, "c", EmulatedChunks))
    assert got.iterations == 0 and torch.equal(got.x, torch.zeros_like(b))


def test_cpu_and_mesh_take_the_eager_loops_and_stages():
    v = torch.zeros(64)
    mesh = device_mesh(devices=["cpu"] * 2)
    assert graphs.runner({}, "k", v) is None
    assert graphs.runner({}, "k", tgrid.KKTPair(v, torch.zeros(3))) is None
    assert graphs.runner({}, "k", shard_rows(v, mesh)) is None
    assert graphs.stage_runner({}, "k", "cpu") is None
    assert graphs.stage_runner(None, "k", "cuda") is None
    assert isinstance(graphs.stage_runner({}, "k", "cuda"), graphs.Cached)
    # solves on the CPU and on a CPU mesh keep no graph of any kind
    opts = SignedHeatOptions(dtype="float32", refine_steps=0, disk_cache=False)
    for solver in (tgrid.GridSolver(device="cpu"), tgrid.GridSolver(mesh=mesh)):
        solver.compute_distance(make_icosphere(1), opts)
        (cached,) = solver._cache.values()
        assert not cached.get("graphs")


def test_stop_kernel_refuses_cpu_tensors():
    """No silent fallback: the kernel's wrapper raises on what it does not
    take, and the dispatch sends only CPU tensors to the plain version."""
    s, go = stop.new_state("cpu")
    with pytest.raises(ValueError, match="CUDA"):
        stop.cg_stop_cuda(torch.ones(()), None, s, go, start=True)
    with pytest.raises(ValueError, match="CUDA"):
        stop.minres_stop_cuda(torch.ones(()), torch.ones(()), torch.ones(()), s, go,
                              start=True)


def test_chunk_graph_refuses_another_setup():
    with pytest.raises(ValueError, match="setup"):
        graphs.ChunkGraph(None, None, None, variant=("cg", False)).solve(
            {}, torch.zeros(5), variant=("cg", True))


# --- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    from shm3d_torch._device import resolve_device

    return resolve_device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_stop_kernel_matches_plain(cuda_device, dtype):
    """Random r.z, phibar and beta sequences (with NaN, inf and zeros): the
    kernel's state after every call equal to the plain version's."""
    rng = np.random.default_rng(11)
    vals = np.concatenate([rng.lognormal(0, 3, 300) * rng.choice([-1, 1], 300),
                           [0.0, -0.0, np.nan, np.inf, -np.inf, 1e-40]])
    rng.shuffle(vals)
    for start_val in vals[:20]:
        s_h, go_h = stop.new_state("cpu")
        s_h[:5] = stop.params(1e-3, 200, 7, torch.finfo(dtype).tiny)
        s_d, go_d = s_h.to(cuda_device), go_h.to(cuda_device)
        t = lambda v, dev: torch.tensor(v, dtype=dtype, device=dev)
        stop.cg_stop_torch(t(start_val, "cpu"), t(vals[-1], "cpu"), s_h, go_h, True)
        stop.cg_stop_cuda(t(start_val, cuda_device), t(vals[-1], cuda_device), s_d, go_d, True)
        for v in vals[:60]:
            stop.cg_stop_torch(t(v, "cpu"), None, s_h, go_h, False)
            stop.cg_stop_cuda(t(v, cuda_device), None, s_d, go_d, False)
            assert torch.equal(s_d.cpu().nan_to_num(7.0), s_h.nan_to_num(7.0))
            assert bool(go_d) == bool(go_h)
        stop.minres_stop_torch(t(start_val, "cpu"), t(1.0, "cpu"), t(vals[3], "cpu"),
                               s_h, go_h, True)
        stop.minres_stop_cuda(t(start_val, cuda_device), t(1.0, cuda_device),
                              t(vals[3], cuda_device), s_d, go_d, True)
        for a, b in zip(vals[:40], vals[40:80]):
            stop.minres_stop_torch(t(a, "cpu"), t(b, "cpu"), None, s_h, go_h, False)
            stop.minres_stop_cuda(t(a, cuda_device), t(b, cuda_device), None, s_d, go_d,
                                  False)
            assert torch.equal(s_d.cpu().nan_to_num(7.0), s_h.nan_to_num(7.0))


@pytest.mark.cuda
@pytest.mark.parametrize("cap", [400, 7, 1])
def test_cuda_chunk_graph_matches_eager(cuda_device, cap):
    """CG on a sliced-ELL operator and MINRES on a dense one, run to the
    stop or cut by maxiter: the chunk graphs against the eager loops bit
    for bit, one conditional node a chunk graph, one host read a solve,
    equal K2 launches on a warm solve."""
    rng = np.random.default_rng(13)
    n = 500
    A = rng.normal(size=(n, n)) * (rng.uniform(size=(n, n)) < 0.02)
    A = A @ A.T + n * 0.05 * np.eye(n)
    S = ell.device_put_tree(pell.sell_from_csr(scipy.sparse.csr_matrix(A), np.float32),
                            cuda_device)
    Ad = torch.as_tensor(A, dtype=torch.float32, device=cuda_device)
    matvec = lambda x: pell.sell_matvec(S, x)
    b = torch.as_tensor(rng.normal(size=n), dtype=torch.float32, device=cuda_device)
    d = Ad.diagonal().clone()
    kw = dict(precond=lambda r: r / d, tol=1e-6, maxiter=cap)
    k2 = pell.KERNEL_LAUNCHES
    want = krylov.cg(matvec, b, **kw)
    eager_k2 = pell.KERNEL_LAUNCHES - k2
    cache = {}
    for _ in range(2):
        k2 = pell.KERNEL_LAUNCHES
        got = krylov.cg_run(matvec, b, runner=graphs.runner(cache, "cg", b), **kw)
        assert (got.iterations, got.residual) == (want.iterations, want.residual)
        assert torch.equal(got.x, want.x)
    assert pell.KERNEL_LAUNCHES - k2 == eager_k2
    g = cache["cg"]
    assert [c for _, c in g.node_counts] == [1] and g.reads == 2
    B = rng.normal(size=(60, 60))
    M = torch.as_tensor((B + B.T) / 2 + np.diag(np.linspace(-5, 5, 60)), device=cuda_device)
    bm = torch.as_tensor(rng.normal(size=60), device=cuda_device)
    want = krylov.minres(lambda x: M @ x, bm, tol=1e-10, maxiter=cap)
    for _ in range(2):
        got = krylov.minres_run(lambda x: M @ x, bm, tol=1e-10, maxiter=cap,
                                runner=graphs.runner(cache, "minres", bm))
        assert (got.iterations, got.residual) == (want.iterations, want.residual)
        assert torch.equal(got.x, want.x)
    assert [c for _, c in cache["minres"].node_counts] == [1, 1]


@pytest.mark.cuda
@pytest.mark.parametrize("loop", [True, False])
def test_cuda_chunk_start_matches_plain(cuda_device, loop):
    """The start kernel against its plain version: a chunk graph whose body
    adds 1 to a counter and runs the stop kernel (three iterations to its
    maxiter) runs its body as the plain condition says, for go false and
    true, WHILE (to the stop) and IF (once)."""
    count = torch.zeros((), dtype=torch.int64, device=cuda_device)
    rz = torch.ones((), device=cuda_device)
    st, go = stop.new_state(cuda_device)
    chunk = stop.CondGraph(cuda_device, loop)
    body = torch.cuda.CUDAGraph(keep_graph=True)
    cond = stop.chunk_condition(chunk.handle) if loop else contextlib.nullcontext()
    with graphs.LaunchCounts().recording(), cond, torch.cuda.graph(body):
        count.add_(1)
        stop.cg_stop_cuda(rz, None, st, go, False)
    chunk.build(body.raw_cuda_graph(), go)
    fresh = torch.zeros(stop.NSLOTS, dtype=torch.float64)
    fresh[:5] = stop.params(0.0, 3, 1 << 30, 1e-38)
    for g in (False, True, False, True):
        count.zero_()
        st.copy_(fresh)
        go.fill_(g)
        want = (3 if loop else 1) if stop.chunk_start_torch(go) else 0
        chunk.launch(torch.cuda.current_stream(cuda_device))
        torch.cuda.synchronize()
        assert int(count) == want and int(st[stop.K].item()) == want
