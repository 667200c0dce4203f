"""The grid's host-projected loop and the greedy wavefront as graphs
(``solvers.grid._solve_pinned_hostproj`` on ``graphs.hostproj_runner``,
``ops.wavefront.greedy_integrate_wavefront`` on ``graphs.wavefront_runner``).

On the CPU the bodies run step by step through the stand-in stepper of
tests/test_torch_graphs.py (``InPlace``), here with the exchange buffers'
``read`` and ``write`` as plain copies, kept in the same caches as the
graphs are:

- the segmented host-projected loop (three bodies an iteration, the host's
  Gram solves between them) gives the eager loop's u, iterations, residual
  and Gram-solve counts bit for bit: float32 and float64, a stall stop, and
  ``maxiter`` reached two iterations into a batch of four;
- its three segments equal shm3d's ``_hp_step1/2/3`` in float64 (JAX in
  x64 on the CPU) to 1e-12 relative at 16^3 on an icosphere;
- the wavefront's chunk body gives the eager sweeps bit for bit and shm3d's
  ``_sweep_chunk`` to 1e-12 after every chunk, the last, shorter one too;
- the caches: a new geometry or dtype gets its own host-projected and
  wavefront graphs; the primary and correction solves of one
  discretization share the loop's graph and give the eager results.

The grid's tier caps are patched low (as in tests/test_torch_grid_tiers.py)
so a 16^3 icosphere takes the host-projected and subsampled tiers.  Marked
``cuda`` (skipped without a card): graphed against eager bit for bit on
each loop.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shm3d.ops import wavefront as jwave
from shm3d.solvers import grid as jgrid
from shm3d_torch.config import SignedHeatOptions
from shm3d_torch.geometry.procedural import make_icosphere, make_sphere_cloud
from shm3d_torch.ops import wavefront
from shm3d_torch.solve import graphs, multigrid, projection
from shm3d_torch.solvers import grid as tgrid
from test_torch_graphs import _stand_in as chunk_stand_in

torch.set_num_threads(2)


class Segmented:
    """A loop's bodies called in place on state buffers of their own, no
    capture (every step launches what its body launches), with the exchange
    buffers of a segmented stepper: ``graphs.IterationGraph``'s interface
    on the CPU.  The state is on the host already, so ``read`` and
    ``write`` are copies."""

    def __init__(self, init: dict, make_bodies, exchange=()):
        self.state = {k: v.clone() for k, v in init.items()}
        self.bodies = make_bodies(self.state)
        self.exchange = tuple(exchange)

    def load(self, init: dict) -> None:
        for k, v in init.items():
            self.state[k].copy_(v)

    def step(self, i: int = 0) -> None:
        self.bodies[i]()

    def read(self, name: str) -> torch.Tensor:
        assert name in self.exchange
        return self.state[name].clone()

    def write(self, name: str, value: torch.Tensor) -> None:
        assert name in self.exchange
        self.state[name].copy_(value)


def _stand_in(cache, key, b):
    if cache is None or not isinstance(b, torch.Tensor):
        return None
    return graphs.Cached(cache, key, Segmented)


@contextlib.contextmanager
def stand_ins():
    """The three runners give the stand-in steppers for CPU tensors (the
    Krylov loops ``test_torch_graphs``'s chunk stand-in)."""
    names = ("runner", "hostproj_runner", "wavefront_runner")
    saved = [getattr(graphs, n) for n in names]
    for n, f in zip(names, (chunk_stand_in, _stand_in, _stand_in)):
        setattr(graphs, n, f)
    try:
        yield
    finally:
        for n, f in zip(names, saved):
            setattr(graphs, n, f)


@pytest.fixture
def host_tier(monkeypatch):
    """No device factor of any size: ``max_device_pins=None`` takes the
    host-projected tier, ``max_device_pins=24`` the subsampled one."""
    monkeypatch.setattr(projection, "ORTHO_GRAM_CAP", 0)
    monkeypatch.setattr(projection, "TFORM_FULL_CAP", 0)


def _discretization(dtype):
    """The cache entry of a host-projected solve of the 16^3 icosphere."""
    ts = tgrid.GridSolver(device="cpu")
    opts = SignedHeatOptions(dtype=dtype, refine_steps=0, max_device_pins=None,
                             disk_cache=False)
    ts.compute_distance(make_icosphere(2), opts)
    return next(iter(ts._cache.values()))


def _rhs(cached, seed):
    grid = cached["grid"]
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.normal(size=grid.total_nodes), dtype=cached["coeffs8"].dtype)


def _hostproj(cached, b, tol, maxiter, cache):
    grid = cached["grid"]
    stats = {}
    u, k, rel = tgrid._solve_pinned_hostproj(
        b, cached["nodes8"], cached["coeffs8"], cached["at"], cached["host_gram"],
        float(grid.cell_size), grid.shape, tol, maxiter, stats, cache)
    return u, k, rel, stats["gram_solves"]


HOSTPROJ_CASES = {"f32": ("float32", 1e-5, 2000), "f64": ("float64", 1e-12, 20000),
                  "f32_stall": ("float32", 1e-30, 2000),
                  "maxiter_in_batch": ("float64", 1e-12, 6)}


@pytest.mark.parametrize("case", sorted(HOSTPROJ_CASES))
def test_segmented_hostproj_matches_eager_bitwise(host_tier, case):
    dtype, tol, maxiter = HOSTPROJ_CASES[case]
    cached = _discretization(dtype)
    b = _rhs(cached, 11)
    want = _hostproj(cached, b, tol, maxiter, None)
    cache = {}
    with stand_ins():
        got = _hostproj(cached, b, tol, maxiter, cache)
    assert got[1:] == want[1:]
    assert torch.equal(got[0], want[0])
    (stepper,) = cache.values()
    assert isinstance(stepper, Segmented) and len(stepper.bodies) == 3
    assert got[0] is not stepper.state["u"]   # the caller gets a copy
    assert got[3] == 2 + 2 * got[1]           # two Gram solves an iteration
    if case == "maxiter_in_batch":
        assert got[1] == 6
    elif case == "f32_stall":
        assert got[1] % tgrid.HOSTPROJ_CHECK_EVERY == 0 and got[1] < maxiter


def test_hostproj_segments_match_shm3d_steps(host_tier):
    """Each segment from the same state as shm3d's step, float64 (JAX x64)."""
    cached = _discretization("float64")
    grid = cached["grid"]
    shape, cell, N = grid.shape, float(grid.cell_size), grid.total_nodes
    m = cached["nodes8"].shape[0]
    rng = np.random.default_rng(12)
    s = {k: torch.as_tensor(rng.normal(size=N)) for k in ("u", "r", "p", "Hp", "Mr")}
    s.update(rz=torch.tensor(float(rng.uniform(0.5, 2.0)), dtype=torch.float64),
             a1=torch.zeros(m, dtype=torch.float64), a2=torch.zeros(m, dtype=torch.float64),
             z1=torch.as_tensor(rng.normal(size=m)), z2=torch.as_tensor(rng.normal(size=m)))
    nodes8, coeffs8 = cached["nodes8"], cached["coeffs8"]
    mg = multigrid.make_node_preconditioner(shape, cell)
    step1, step2, step3 = tgrid._hostproj_segments(
        s, lambda u: -tgrid._lap(u, cell, shape), mg,
        lambda v: projection.a_apply(v, nodes8, coeffs8),
        lambda z: projection.at_apply(z, cached["at"], N))
    jn, jc = jnp.asarray(nodes8.numpy()), jnp.asarray(coeffs8.numpy())

    def j(name):
        # a copy: the port's steps write the state in place, and JAX on the
        # CPU may alias a numpy buffer and read it after they did
        return jnp.array(s[name].numpy(), copy=True)

    def close(got, ref):
        got, ref = got.numpy(), np.asarray(ref)
        assert np.linalg.norm(got - ref) <= 1e-12 * np.linalg.norm(ref), (got, ref)

    ref = jax.block_until_ready(jgrid._hp_step1(j("p"), jn, jc, cell, shape))
    step1()
    close(s["Hp"], ref[0])
    close(s["a1"], ref[1])
    ref = jax.block_until_ready(jgrid._hp_step2(
        j("u"), j("r"), j("p"), j("Hp"), j("z1"), j("rz"), jn, jc, cell, shape,
        cycles=jgrid.HOSTPROJ_MG_CYCLES))
    step2()
    for k, r in zip(("u", "r", "Mr", "a2"), ref):
        close(s[k], r)
    ref = jax.block_until_ready(jgrid._hp_step3(j("r"), j("Mr"), j("z2"), j("p"), j("rz"),
                                                jn, jc))
    step3()
    close(s["p"], ref[0])
    close(s["rz"], ref[1])


@pytest.mark.parametrize("n", [13, 17])
def test_wavefront_chunks_match_eager_and_shm3d(n):
    """n = 13: 36 sweeps, chunks 16 + 16 + 4; n = 17: 48, three full
    chunks.  A random unit field, float64."""
    shape = (n, n, n)
    cell = 0.25
    rng = np.random.default_rng(n)
    Y = rng.normal(size=(n ** 3, 3))
    Y /= np.linalg.norm(Y, axis=1, keepdims=True)
    Yt = torch.as_tensor(Y)
    want = wavefront.greedy_integrate_wavefront(Yt, cell, shape)
    cache = {}
    with stand_ins():
        got = wavefront.greedy_integrate_wavefront(Yt, cell, shape, cache=cache)
    assert got[1:] == want[1:] == (3 * (n - 1), n ** 3)
    assert torch.equal(got[0], want[0])
    (stepper,) = cache.values()
    sizes = [16, 4] if n == 13 else [16]
    assert len(stepper.bodies) == len(sizes)

    # chunk by chunk against shm3d's _sweep_chunk
    s = {k: v.clone() for k, v in stepper.state.items()}
    s["phi"].zero_()
    s["visited"].zero_()
    s["visited"][0, 0, 0] = True
    dirs = [(2 - axis, delta) for axis in (0, 1, 2) for delta in (-1, 1)]
    jphi, jvis = jnp.zeros(shape), jnp.zeros(shape, bool).at[0, 0, 0].set(True)
    Y3 = jnp.asarray(Y.reshape(*shape, 3))
    done = 0
    while done < 3 * (n - 1):
        count = min(16, 3 * (n - 1) - done)
        wavefront.chunk_body(s, dirs, count)
        jphi, jvis = jwave._sweep_chunk(jphi, jvis, Y3, jnp.asarray(cell), shape, count)
        done += count
        np.testing.assert_array_equal(s["visited"].numpy(), np.asarray(jvis))
        np.testing.assert_allclose(s["phi"].numpy(), np.asarray(jphi), rtol=0,
                                   atol=1e-12 * float(np.abs(np.asarray(jphi)).max()))
        assert bool(s["done"]) == bool(jnp.all(jvis))
    assert np.array_equal(s["phi"].numpy().reshape(-1), want[0].numpy())


# --- through the solver: the caches ------------------------------------------


def _solve(ts, geom, opts):
    res = ts.compute_distance(geom, opts)
    st = ts.last_stats
    keep = ("iters", "rel_res", "correction_iters", "refine_pass_rels", "refine_rel_res",
            "wavefront_sweeps", "wavefront_visited", "tier", "step3_path")
    out = {k: st.get(k) for k in keep}
    for k in ("host_loop", "correction_host_loop"):
        out[k] = st.get(k, {}).get("gram_solves")
    return res.phi, out


@pytest.mark.parametrize("tier", ["host-projected", "subsampled"])
def test_primary_and_correction_share_the_loop_graph(host_tier, tier):
    """The default tier: on the host-projected tier the primary solve and
    every correction run the loop on one graph; on the subsampled tier the
    primary solve is projected CG and the corrections run the loop over all
    rows.  Bit for bit the eager solves."""
    geom = make_icosphere(2)
    opts = SignedHeatOptions(dtype="float32", refine_steps=3, refine_target=1e-9,
                             max_device_pins=None if tier == "host-projected" else 24,
                             disk_cache=False)
    ts = tgrid.GridSolver(device="cpu")
    ephi, est = _solve(ts, geom, opts)
    with stand_ins():
        sphi, sst = _solve(ts, geom, opts)
    assert np.array_equal(sphi, ephi) and sst == est
    assert est["tier"] == tier and len(est["correction_iters"]) >= 1
    cached = next(iter(ts._cache.values()))
    kinds = sorted(k[0] for k in cached["graphs"])
    assert kinds == (["host-projected"] if tier == "host-projected"
                     else ["host-projected", "projected-cg"])
    loop = cached["graphs"][("host-projected", "all rows", cached["grid"].shape, torch.float32)]
    assert isinstance(loop, Segmented)
    with stand_ins():   # a second solve replays the same graph
        again, _ = _solve(ts, geom, opts)
    assert np.array_equal(again, ephi)
    assert cached["graphs"][("host-projected", "all rows", cached["grid"].shape,
                             torch.float32)] is loop


def test_hostproj_graph_cache_rekeys_on_new_geometry_and_dtype(host_tier):
    ts = tgrid.GridSolver(device="cpu")
    ico, cloud = make_icosphere(2), make_sphere_cloud(800)
    f32 = SignedHeatOptions(dtype="float32", refine_steps=0, max_device_pins=None,
                            disk_cache=False)
    with stand_ins():
        first, _ = _solve(ts, ico, f32)
        (key_a, cached_a), = ts._cache.items()
        (loop_a,) = cached_a["graphs"].values()
        _solve(ts, cloud, f32)
        _solve(ts, ico, f32.with_(dtype="float64"))
        again, _ = _solve(ts, ico, f32)
    entries = list(ts._cache.values())
    assert len(entries) == 3
    loops = [next(iter(c["graphs"].values())) for c in entries]
    assert len({id(x) for x in loops}) == 3
    assert [k[3] for c in entries for k in c["graphs"]] == [
        torch.float32, torch.float32, torch.float64]
    assert cached_a["graphs"][next(iter(cached_a["graphs"]))] is loop_a
    assert np.array_equal(again, first)


def test_wavefront_graph_cache_rekeys_and_matches_eager():
    """fast_integration at 34^3 (h_coef=1.1: the device wavefront, 99
    sweeps in chunks 16 x 6 + 3): the stand-in gives the eager phi and
    stats; a new geometry and a new dtype get their own chunk graphs."""
    ico, cloud = make_icosphere(2), make_sphere_cloud(800)
    opts = SignedHeatOptions(dtype="float32", fast_integration=True, h_coef=1.1,
                             disk_cache=False)
    ts = tgrid.GridSolver(device="cpu")
    ephi, est = _solve(ts, ico, opts)
    with stand_ins():
        sphi, sst = _solve(ts, ico, opts)
        _solve(ts, cloud, opts)
        _solve(ts, ico, opts.with_(dtype="float64"))
    assert est["step3_path"] == "greedy-wavefront" and est["wavefront_sweeps"] == 99
    assert np.array_equal(sphi, ephi) and sst == est
    entries = list(ts._cache.values())
    assert len(entries) == 3
    steppers = [c["graphs"][("wavefront", (34, 34, 34), dt)]
                for c, dt in zip(entries, (torch.float32, torch.float32, torch.float64))]
    assert len({id(x) for x in steppers}) == 3
    assert all(isinstance(x, Segmented) and len(x.bodies) == 2 for x in steppers)


def test_new_runners_take_the_eager_loop_off_one_cuda_device():
    from shm3d_torch.parallel import device_mesh
    from shm3d_torch.parallel.shards import shard_rows

    v = torch.zeros(64)
    mesh = device_mesh(devices=["cpu"] * 2)
    for run in (graphs.hostproj_runner, graphs.wavefront_runner):
        assert run({}, "k", v) is None
        assert run(None, "k", v) is None
        assert run({}, "k", shard_rows(v, mesh)) is None


# --- on the card -------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    from shm3d_torch._device import resolve_device

    return resolve_device("cuda")


@contextlib.contextmanager
def eager_loops():
    names = ("runner", "stage_runner", "hostproj_runner", "wavefront_runner")
    saved = [getattr(graphs, n) for n in names]
    for n in names:
        setattr(graphs, n, lambda *args, **kw: None)
    try:
        yield
    finally:
        for n, f in zip(names, saved):
            setattr(graphs, n, f)


@pytest.mark.cuda
@pytest.mark.parametrize("loop", ["host-projected", "wavefront"])
def test_cuda_graphed_loop_matches_eager_bitwise(cuda_device, host_tier, loop):
    """Warm solves: one eager, two graphed (the first captures), bit for
    bit: the host-projected default tier in float32 (primary and
    corrections on one graph) and the wavefront at 34^3."""
    geom = make_icosphere(2)
    if loop == "host-projected":
        opts = SignedHeatOptions(dtype="float32", refine_steps=2, max_device_pins=None,
                                 disk_cache=False)
    else:
        opts = SignedHeatOptions(dtype="float32", fast_integration=True, h_coef=1.1,
                                 disk_cache=False)
    ts = tgrid.GridSolver(device=cuda_device)
    ts.compute_distance(geom, opts)
    runs = []
    for mode in ("eager", "graph", "graph"):
        with eager_loops() if mode == "eager" else contextlib.nullcontext():
            runs.append(_solve(ts, geom, opts))
            torch.cuda.synchronize()
    (ephi, est), (g1, s1), (g2, s2) = runs
    assert np.array_equal(g1, ephi) and np.array_equal(g2, ephi)
    assert s1 == est and s2 == est
    cached = next(iter(ts._cache.values()))
    (key, stepper), = [(k, g) for k, g in cached["graphs"].items()
                       if not isinstance(g, graphs.StageGraph)]
    assert key[0] == loop and isinstance(stepper, graphs.IterationGraph)
    # the grid's stages beside the loop: Steps 1-2, the mean shift and, on
    # the exact path, the divergence
    stages = sorted(k[0] for k, g in cached["graphs"].items() if isinstance(g, graphs.StageGraph))
    assert stages == (["divergence", "mean shift", "steps 1-2"] if loop == "host-projected"
                      else ["mean shift", "steps 1-2"])
    assert sorted(stepper.host) == (["a1", "a2", "z1", "z2"] if loop == "host-projected" else [])
