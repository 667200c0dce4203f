"""The port's multi-device grid solve (shm3d_torch.parallel, GridSolver(mesh=))
on a mesh of CPU shards in one process, against shm3d.parallel on the 8
virtual CPU devices tests/conftest.py gives JAX, and against the port's own
single-device solve.  Both packages take the same numpy inputs, in float64
unless a case says otherwise.

Tolerances are tests/test_parallel.py's for the same properties.  The slab
operators (Laplacian, divergence, V-cycle, A u, A^T y, the projectors) take
every node through the single-device operations in their order, so they
are held bitwise equal to the single-device forms; a 1-D and a 2-D mesh over
the same shards, and two solves on one mesh, give one phi bit for bit.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shm3d import parallel as jpar
from shm3d.geometry import sources as jsrc
from shm3d.ops import farfield as jfarfield
from shm3d.ops import stencil as jstencil
from shm3d.solve import krylov as jkrylov
from shm3d.solvers.grid import GridSolver as JaxGridSolver
from shm3d_torch import cli
from shm3d_torch.api import SignedHeatSolver
from shm3d_torch.config import SignedHeatOptions
from shm3d_torch.domains.grid import build_grid
from shm3d_torch.geometry.procedural import make_icosphere
from shm3d_torch.ops import farfield, stencil
from shm3d_torch.parallel import Shards, device_mesh, node_sharding, slab, yukawa_field_ring
from shm3d_torch.solve import krylov, multigrid, projection
from shm3d_torch.solvers import grid as tgrid
from torch_interop import jax_geom, jax_options

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUNNY = os.path.join(REPO, "tests", "data", "bunny_dec.obj")


@pytest.fixture(scope="module")
def jmesh8():
    assert len(jax.devices()) >= 8, "conftest must force 8 virtual CPU devices"
    return jpar.device_mesh(8)


def cpu_mesh(n, n_slices=1):
    return device_mesh(devices=["cpu"] * n, n_slices=n_slices)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def ico_sources():
    """(points, vectors) of an 80-face icosphere, float64 host arrays."""
    from shm3d.geometry.procedural import make_icosphere as jico

    src = jsrc.from_mesh(jico(1))
    return np.asarray(src.points, np.float64), np.asarray(src.vectors(), np.float64)


def _ring_both(q, pts, vecs, lam, jmesh, tmesh, **kw):
    want = np.asarray(jpar.yukawa_field_ring(jnp.asarray(q), jnp.asarray(pts),
                                             jnp.asarray(vecs), lam, jmesh, **kw))
    got = yukawa_field_ring(torch.as_tensor(q), torch.as_tensor(pts), torch.as_tensor(vecs),
                            lam, tmesh, **kw)
    return got, want


def test_ring_yukawa_matches_shm3d(jmesh8, ico_sources):
    q = np.random.default_rng(11).uniform(-2, 2, size=(256, 3))
    got, want = _ring_both(q, *ico_sources, 2.7, jmesh8, cpu_mesh(8))
    assert isinstance(got, Shards) and [p.shape[0] for p in got.parts] == [32] * 8
    np.testing.assert_allclose(got.gather().numpy(), want, rtol=1e-12, atol=1e-13)


def test_ring_yukawa_unnormalized(jmesh8, ico_sources):
    q = np.random.default_rng(12).uniform(-2, 2, size=(64, 3))
    got, want = _ring_both(q, *ico_sources, 1.3, jmesh8, cpu_mesh(8), normalize=False)
    np.testing.assert_allclose(got.gather().numpy(), want, rtol=1e-10, atol=1e-12)


def test_ring_yukawa_self_padding(jmesh8, ico_sources):
    """101 queries and 77 sources over 8 shards: both padded inside the ring."""
    pts, vecs = ico_sources
    q = np.random.default_rng(15).uniform(-2, 2, size=(101, 3))
    got, want = _ring_both(q, pts[:77], vecs[:77], 2.0, jmesh8, cpu_mesh(8), q_tile=16)
    assert got.shape == (101, 3)
    np.testing.assert_allclose(got.gather().numpy(), want, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("n_slices", [2, 4])
def test_hierarchical_ring_matches_shm3d(ico_sources, n_slices):
    """The 2-D mesh's hierarchical ring against shm3d's, and bitwise equal
    to the port's flat ring: the partials merge in the sources' home order."""
    q = np.random.default_rng(21).uniform(-2, 2, size=(256, 3))
    jmesh = jpar.device_mesh(8, n_slices=n_slices)
    tmesh = cpu_mesh(8, n_slices=n_slices)
    assert tmesh.axis_names == ("s", "d") and tmesh.shape == (n_slices, 8 // n_slices)
    got, want = _ring_both(q, *ico_sources, 2.7, jmesh, tmesh)
    np.testing.assert_allclose(got.gather().numpy(), want, rtol=1e-12, atol=1e-13)
    flat = yukawa_field_ring(torch.as_tensor(q), *map(torch.as_tensor, ico_sources), 2.7,
                             cpu_mesh(8))
    assert torch.equal(got.gather(), flat.gather())


def test_slab_stencils_match(jmesh8):
    """The slab Laplacian and divergence against shm3d's z-sharded stencils
    (XLA's halos), and bitwise equal to the port's single-device ones."""
    n, cell = 16, 0.3
    rng = np.random.default_rng(13)
    u, Y = rng.normal(size=(n, n, n)), rng.normal(size=(n, n, n, 3))
    us = jax.device_put(jnp.asarray(u), jpar.field3_sharding(jmesh8))
    Ys = jax.device_put(jnp.asarray(Y), jpar.field3v_sharding(jmesh8))
    want_L = np.asarray(jax.jit(lambda x: jstencil.laplacian_apply(x, cell))(us))
    want_D = np.asarray(jax.jit(lambda x: jstencil.divergence_apply(x, cell))(Ys))
    tu, tY = torch.as_tensor(u), torch.as_tensor(Y)
    got_L = torch.cat(slab.laplacian_apply(list(torch.chunk(tu, 8)), cell))
    got_D = torch.cat(slab.divergence_apply(list(torch.chunk(tY, 8)), cell))
    np.testing.assert_allclose(got_L.numpy(), want_L, atol=1e-12)
    np.testing.assert_allclose(got_D.numpy(), want_D, atol=1e-12)
    assert torch.equal(got_L, stencil.laplacian_apply(tu, cell))
    assert torch.equal(got_D, stencil.divergence_apply(tY, cell))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("pinned", [False, True])
@pytest.mark.parametrize("shards", [2, 4, 8])
def test_slab_v_cycle_bitwise(dtype, pinned, shards):
    """One slab V-cycle (n = 32) equals ``v_cycle`` bit for bit, pin masks
    included; every mesh gathers the coarsest levels onto its first shard."""
    n, cell = 32, 0.3
    rng = np.random.default_rng(shards)
    b = torch.as_tensor(rng.standard_normal((n, n, n)), dtype=dtype)
    pins = spins = None
    if pinned:
        nodes8 = torch.as_tensor(rng.integers(0, n ** 3, size=(300, 8)))
        pins = multigrid.build_pin_masks(nodes8, (n, n, n), dtype)
        spins = multigrid.build_slab_pin_masks(nodes8, n, cpu_mesh(shards), dtype)
        assert len(spins) == len(pins)
        for full, level in zip(pins, spins):
            assert torch.equal(full, level if isinstance(level, torch.Tensor) else torch.cat(level))
    want = multigrid.v_cycle(b, cell, pins=pins)
    got = multigrid.v_cycle_slabs(list(torch.chunk(b, shards)), cell, pins=spins)
    assert torch.equal(torch.cat(got), want)
    level, n_level = multigrid.slab_gather_level(n, shards)
    assert 0 < level <= 2 and n_level <= 16
    if pinned:  # the gathered levels are full tensors
        assert isinstance(spins[level], torch.Tensor) and isinstance(spins[level - 1], list)


@pytest.fixture(scope="module")
def rows16():
    """A 16^3 icosphere grid's constraint rows, float64, and its Gram table."""
    from shm3d_torch.domains import grid as griddom

    geom = make_icosphere(2)
    grid = build_grid(geom.vertices, 2.0, 0.0)
    src = tgrid.GridSolver._sources(geom)
    nodes8, coeffs8 = griddom.constraint_rows(grid, src.points)
    return grid, nodes8, np.asarray(coeffs8, np.float64)


@pytest.mark.parametrize("shards", [4, 8])
def test_slab_projection_bitwise(rows16, shards):
    """A u, A^T y and both projectors (bmat, tmat) on z-slabs equal the
    single-device forms bit for bit."""
    grid, nodes8, coeffs8 = rows16
    N, mesh = grid.total_nodes, cpu_mesh(shards)
    rng = np.random.default_rng(3)
    u = torch.as_tensor(rng.standard_normal(N))
    y = torch.as_tensor(rng.standard_normal(nodes8.shape[0]))
    n8, c8 = torch.as_tensor(nodes8, dtype=torch.int64), torch.as_tensor(coeffs8)
    at = projection.at_table(nodes8, coeffs8, "cpu", torch.float64)
    gather = projection.NodeGather(nodes8, mesh, N // shards)
    sat = projection.SlabAt(at, mesh, N // shards)
    us = node_sharding(u, mesh)
    assert torch.equal(projection.a_apply(us, gather, c8), projection.a_apply(u, n8, c8))
    assert torch.equal(projection.at_apply(y, sat, N).gather(), projection.at_apply(y, at, N))
    for arrays in (projection.build_gram_arrays(nodes8, coeffs8, N, np.float64),
                   projection.build_tform_arrays(nodes8, coeffs8, N)):
        gram = projection.gram_from_arrays(arrays, "cpu", torch.float64)
        want = projection.make_projector(n8, c8, gram, N, at)(u)
        got = projection.make_projector(gather, c8, gram, N, sat)(us)
        assert torch.equal(got.gather(), want)


def test_sharded_cg_poisson_matches(jmesh8):
    """CG on z-slabs (dots summed in shard order) on a shifted Laplacian:
    shm3d's z-sharded CG, and the port's single-device CG."""
    n, cell = 16, 0.25
    shape = (n, n, n)
    b = np.random.default_rng(14).normal(size=n ** 3)

    def jmatvec(x):
        u = x.reshape(shape)
        return (-jstencil.laplacian_apply(u, cell) + 5.0 * u).reshape(-1)

    bs = jax.device_put(jnp.asarray(b), jpar.node_sharding(jmesh8))
    want = np.asarray(jax.jit(lambda bb: jkrylov.cg(jmatvec, bb, tol=1e-12, maxiter=500).x)(bs))

    def matvec(x):
        return -tgrid._lap(x, cell, shape) + 5.0 * x

    got = krylov.cg(matvec, node_sharding(torch.as_tensor(b), cpu_mesh(8)), tol=1e-12,
                    maxiter=500)
    single = krylov.cg(matvec, torch.as_tensor(b), tol=1e-12, maxiter=500)
    np.testing.assert_allclose(got.x.gather().numpy(), want, rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(got.x.gather().numpy(), single.x.numpy(), rtol=1e-9, atol=1e-10)
    assert abs(got.iterations - single.iterations) <= 1


F64 = SignedHeatOptions(dtype="float64", solver_tol=1e-11, solver_maxiter=5000,
                        refine_steps=0, disk_cache=False)


def test_grid_solver_mesh_matches(jmesh8):
    """GridSolver(mesh=) against shm3d's GridSolver(mesh=mesh8) and the
    port's single-device solve (dense Step 1 on the ring)."""
    geom = make_icosphere(2)
    want = JaxGridSolver(mesh=jmesh8).compute_distance(jax_geom(geom), jax_options(F64)).phi
    single = tgrid.GridSolver(device="cpu").compute_distance(geom, F64).phi
    solver = tgrid.GridSolver(mesh=cpu_mesh(8))
    got = solver.compute_distance(geom, F64).phi
    mesh = solver.last_stats["mesh"]
    assert mesh["fallback"] is False and mesh["step3"] == "z-slabs"
    assert mesh["shape"] == [8] and mesh["gather_level"] == 1 and mesh["gather_n"] == 8
    assert _rel(got, np.asarray(want)) < 1e-9
    assert _rel(got, single) < 1e-9


def test_grid_solver_mesh_indivisible_falls_back():
    """n = 16 does not split over 5 shards: the single-device solve, on the
    mesh's first device, recorded as a fallback."""
    geom = make_icosphere(1)
    opts = SignedHeatOptions(dtype="float64", refine_steps=0, disk_cache=False)
    single = tgrid.GridSolver(device="cpu").compute_distance(geom, opts).phi
    solver = tgrid.GridSolver(mesh=cpu_mesh(5))
    got = solver.compute_distance(geom, opts).phi
    np.testing.assert_allclose(got, single, rtol=1e-10)
    assert np.array_equal(got, single)
    assert solver.last_stats["mesh"]["fallback"] is True


def test_grid_solver_multislice_matches_single():
    """A 2x4 mesh end to end (hierarchical ring, slabs over both axes)."""
    geom = make_icosphere(1)
    opts = SignedHeatOptions(dtype="float64", h_coef=0.0, disk_cache=False)
    single = tgrid.GridSolver(device="cpu").compute_distance(geom, opts).phi
    solver = tgrid.GridSolver(mesh=cpu_mesh(8, n_slices=2))
    got = solver.compute_distance(geom, opts).phi
    assert solver.last_stats["mesh"]["axis_names"] == ["s", "d"]
    assert _rel(got, single) < 1e-8


def test_shell_step1_sharded_matches(jmesh8):
    """The row-sharded shell and coarse launches and the assembly: the
    single-device shell field, and shm3d's sharded one, float32."""
    geom = make_icosphere(2)
    src = tgrid.GridSolver._sources(geom)
    grid = build_grid(geom.vertices, 2.0, 1.0)  # 32^3
    lam = float(1.0 / grid.cell_size)
    plan = farfield.build_shell_plan(grid, src.points, lam, shell_t=4.0, factor=4)
    dplan = farfield.DeviceShellPlan(plan, "cpu", torch.float32)
    pts = torch.as_tensor(src.points, dtype=torch.float32)
    vecs = torch.as_tensor(src.vectors(), dtype=torch.float32)
    Y1 = farfield.yukawa_field_shell(dplan, pts, vecs, lam, grid.n)
    Y8 = farfield.yukawa_field_shell(dplan, pts, vecs, lam, grid.n, mesh=cpu_mesh(8))
    assert isinstance(Y8, Shards) and len(Y8.parts) == 8
    jplan = jfarfield.ShellPlan.from_arrays(plan.arrays())
    want = np.asarray(jfarfield.yukawa_field_shell(
        jplan, jnp.asarray(pts.numpy()), jnp.asarray(vecs.numpy()), lam, grid.n, mesh=jmesh8))
    np.testing.assert_allclose(Y8.gather().numpy(), Y1.numpy(), rtol=0, atol=5e-6)
    np.testing.assert_allclose(Y8.gather().numpy(), want, rtol=0, atol=5e-6)


def test_grid_solver_mesh_shell_matches_single():
    opts = SignedHeatOptions(dtype="float64", h_coef=1.0, solver_tol=1e-11,
                             solver_maxiter=5000, refine_steps=0, disk_cache=False,
                             step1_method="shell", shell_t=4.0)
    geom = make_icosphere(2)
    single = tgrid.GridSolver(device="cpu").compute_distance(geom, opts).phi
    solver = tgrid.GridSolver(mesh=cpu_mesh(8))
    got = solver.compute_distance(geom, opts).phi
    assert "shell_nodes" in solver.last_stats
    assert _rel(got, single) < 1e-9


@pytest.mark.parametrize("tier", ["full-row", "subsampled", "host-projected",
                                  "default-pair", "default-host"])
def test_grid_solver_mesh_tiers_match_single(tier, monkeypatch):
    """Every projector tier, and the default tier's float64 defect
    correction on the device and on the host, on a 4-shard mesh against the
    single-device solve (caps patched low so a 32^3 icosphere takes each)."""
    opts = SignedHeatOptions(dtype="float32", h_coef=1.0, refine_steps=0,
                             solver_tol=1e-6, solver_maxiter=20000, disk_cache=False)
    if tier != "default-pair" and tier != "default-host":
        monkeypatch.setattr(projection, "ORTHO_GRAM_CAP", 0)
    if tier == "subsampled":
        monkeypatch.setattr(projection, "TFORM_FULL_CAP", 0)
        opts = opts.with_(max_device_pins=64)
    elif tier == "host-projected":
        opts = opts.with_(max_device_pins=None)
    elif tier.startswith("default"):
        opts = opts.with_(refine_steps=1, solver_tol=None,
                          refine_mode="pair" if tier == "default-pair" else "host")
    geom = make_icosphere(2)
    s1 = tgrid.GridSolver(device="cpu")
    single = s1.compute_distance(geom, opts).phi
    s4 = tgrid.GridSolver(mesh=cpu_mesh(4))
    got = s4.compute_distance(geom, opts).phi
    assert s4.last_stats["tier"] == s1.last_stats["tier"]
    assert s4.last_stats["tier"] == ("bmat" if tier.startswith("default") else tier)
    assert abs(s4.last_stats["iters"] - s1.last_stats["iters"]) <= 2
    assert _rel(got, single) < 1e-5
    if tier.startswith("default"):
        assert s4.last_stats["refine_rel_res"] < 1e-9


def test_mesh_1d_2d_and_repeated_solves_one_phi():
    """A 1-D and a 2-D mesh over the same shards, and two solves on one
    mesh, give one phi bit for bit (dense Step 1 on the ring, f32)."""
    geom = make_icosphere(1)
    opts = SignedHeatOptions(dtype="float32", refine_steps=1, disk_cache=False)
    s1 = tgrid.GridSolver(mesh=cpu_mesh(4))
    a, b = s1.compute_distance(geom, opts).phi, s1.compute_distance(geom, opts).phi
    c = tgrid.GridSolver(mesh=cpu_mesh(4, n_slices=2)).compute_distance(geom, opts).phi
    assert np.array_equal(a, b) and np.array_equal(a, c)


def test_greedy_on_mesh_gathers():
    geom = make_icosphere(1)
    opts = SignedHeatOptions(dtype="float64", fast_integration=True, disk_cache=False)
    solver = tgrid.GridSolver(mesh=cpu_mesh(4))
    got = solver.compute_distance(geom, opts).phi
    single = tgrid.GridSolver(device="cpu").compute_distance(geom, opts).phi
    assert solver.last_stats["mesh"]["step3"] == "gathered onto cpu"
    assert solver.last_stats["step3_path"] == "greedy-bfs"
    assert _rel(got, single) < 1e-10


def test_tet_domain_on_a_mesh_raises(tmp_path, capsys):
    """The tet domain solves on a mesh of 2 CPU shards through the API and
    the CLI (tests/test_torch_tet_parallel.py holds it to one device and to
    shm3d)."""
    from shm3d_torch.io.mesh_io import write_obj

    geom = make_icosphere(1)
    opts = SignedHeatOptions(dtype="float32", disk_cache=False)
    solver = SignedHeatSolver("tet", mesh=cpu_mesh(2))
    res = solver.compute_distance(geom, opts)
    assert np.isfinite(res.phi).all() and res.phi.shape == (res.mesh.n_vertices,)
    assert solver.last_stats["mesh"]["shape"] == [2] and solver.last_stats["mesh"]["step1"] == "ring"
    obj, phi = tmp_path / "ico.obj", tmp_path / "phi.npy"
    write_obj(str(obj), geom.vertices, geom.faces)
    assert cli.main([str(obj), "--device", "cpu", "--devices", "2", "--no-disk-cache",
                     "--json", "--export-phi", str(phi)]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["domain"] == "tet" and summary["mesh"]["shape"] == [2]
    assert np.array_equal(np.load(phi), res.phi)


def _run(module, args):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    return subprocess.run([sys.executable, "-m", module, *args], capture_output=True,
                          text=True, env=env, cwd=REPO, timeout=300)


def test_cli_grid_on_cpu_devices_writes_phi(tmp_path):
    phi = tmp_path / "phi.npy"
    out = _run("shm3d_torch.cli", [BUNNY, "--g", "--devices", "4", "--device", "cpu",
                                   "--no-disk-cache", "--json", "--export-phi", str(phi)])
    assert out.returncode == 0, out.stderr[-2000:]
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert summary["mesh"]["shape"] == [4] and summary["mesh"]["fallback"] is False
    v = np.load(phi)
    assert v.shape == (16 ** 3,) and np.isfinite(v).all() and v.min() < 0 < v.max()


def test_dryrun_on_cpu_devices():
    out = _run("shm3d_torch.dryrun", ["--devices", "8", "--device", "cpu"])
    assert out.returncode == 0, out.stderr[-2000:]
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert summary["grid_n"] == 16 and summary["mesh2d_equal"] is True


def test_device_mesh_contract():
    mesh = device_mesh(3, device="cpu")
    assert mesh.devices == (torch.device("cpu"),) * 3 and mesh.axis_names == ("d",)
    with pytest.raises(ValueError, match="slices"):
        device_mesh(devices=["cpu"] * 3, n_slices=2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            device_mesh(1)  # the default device type is cuda


def test_split_kernel_wrappers_refuse_cpu_tensors():
    """K1's split entry points launch only on CUDA tensors; the dispatch
    takes the plain versions for CPU tensors."""
    from shm3d_torch.ops import yukawa

    q = torch.zeros((4, 3))
    before = (yukawa.PARTIAL_LAUNCHES, yukawa.MERGE_LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensor"):
        yukawa.yukawa_partials_cuda(q, q, q, 1.0, 256)
    with pytest.raises(TypeError, match="CUDA"):
        yukawa.yukawa_merge_cuda(torch.zeros((1, 4, 4)))
    part = yukawa.yukawa_partials(q + 1.0, q, q + 1.0, 1.0, 2)
    assert part.shape == (2, 4, 4)
    assert yukawa.yukawa_merge(part).shape == (4, 3)
    assert (yukawa.PARTIAL_LAUNCHES, yukawa.MERGE_LAUNCHES) == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    from shm3d_torch._device import resolve_device

    return resolve_device("cuda")


@pytest.mark.cuda
def test_cuda_split_kernels_match_fused_and_plain(cuda_device):
    """Partials then merge through the split entry points are the fused
    call's two kernels: bitwise equal to it, and within 1e-5 of the plain
    versions (float32 sums in another order), one count each."""
    from shm3d_torch.ops import yukawa

    rng = np.random.default_rng(5)
    q = torch.as_tensor(rng.uniform(-1, 1, (5000, 3)), dtype=torch.float32, device=cuda_device)
    p = torch.as_tensor(rng.uniform(-1, 1, (3001, 3)), dtype=torch.float32, device=cuda_device)
    v = rng.normal(size=(3001, 3)) * 0.3
    v[:, 2] += 1.0
    v = torch.as_tensor(v, dtype=torch.float32, device=cuda_device)
    chunk = yukawa.yukawa_chunk_len(5000, 3001, cuda_device)
    before = (yukawa.PARTIAL_LAUNCHES, yukawa.MERGE_LAUNCHES)
    part = yukawa.yukawa_partials_cuda(q, p, v, 7.5, chunk)
    got = yukawa.yukawa_merge_cuda(part)
    assert (yukawa.PARTIAL_LAUNCHES, yukawa.MERGE_LAUNCHES) == (before[0] + 1, before[1] + 1)
    fused = yukawa.yukawa_field_cuda(q, p, v, 7.5)
    ref = yukawa.yukawa_merge_torch(yukawa.yukawa_partials_torch(q, p, v, 7.5, chunk))
    torch.cuda.synchronize()
    assert torch.equal(got, fused)
    assert (got - ref).abs().max().item() <= 1e-5
    assert (part[..., 0] - yukawa.yukawa_partials_torch(q, p, v, 7.5, chunk)[..., 0]).abs().max() \
        .item() <= 1e-3 * float(part[..., 0].abs().max())


@pytest.mark.cuda
def test_cuda_ring_and_slab_v_cycle(cuda_device):
    """On one card as four shards: the ring within 1e-5 of K1 on one device,
    its 1-D and 2 x 2 schedules bitwise equal; the pin-aware slab V-cycle
    bitwise equal to the single-device one."""
    from shm3d_torch.ops import yukawa

    rng = np.random.default_rng(6)
    q = torch.as_tensor(rng.uniform(-1, 1, (8191, 3)), dtype=torch.float32, device=cuda_device)
    p = torch.as_tensor(rng.uniform(-1, 1, (2003, 3)), dtype=torch.float32, device=cuda_device)
    v = rng.normal(size=(2003, 3)) * 0.3
    v[:, 2] += 1.0
    v = torch.as_tensor(v, dtype=torch.float32, device=cuda_device)
    flat = yukawa_field_ring(q, p, v, 7.5, device_mesh(devices=[cuda_device] * 4))
    hier = yukawa_field_ring(q, p, v, 7.5, device_mesh(devices=[cuda_device] * 4, n_slices=2))
    one = yukawa.yukawa_field_cuda(q, p, v, 7.5)
    torch.cuda.synchronize()
    assert torch.equal(flat.gather(), hier.gather())
    assert (flat.gather() - one).abs().max().item() <= 1e-5
    n = 32
    b = torch.as_tensor(rng.standard_normal((n, n, n)), dtype=torch.float32, device=cuda_device)
    nodes8 = torch.as_tensor(rng.integers(0, n ** 3, size=(300, 8)), device=cuda_device)
    mesh = device_mesh(devices=[cuda_device] * 4)
    pins = multigrid.build_pin_masks(nodes8, (n, n, n), torch.float32)
    spins = multigrid.build_slab_pin_masks(nodes8, n, mesh, torch.float32)
    want = multigrid.v_cycle(b, 0.3, pins=pins)
    got = multigrid.v_cycle_slabs(list(b.chunk(4)), 0.3, pins=spins)
    assert torch.equal(torch.cat(got), want)


@pytest.mark.cuda
def test_cuda_rowsharded_step1_bitwise(cuda_device):
    """The row-split K1 launches of a mesh (rows at multiples of the query
    block, the whole launch's source chunks; here the last shard is empty)
    give one launch's field bit for bit."""
    from shm3d_torch.ops import yukawa

    rng = np.random.default_rng(8)
    q = torch.as_tensor(rng.uniform(-1, 1, (5000, 3)), dtype=torch.float32, device=cuda_device)
    p = torch.as_tensor(rng.uniform(-1, 1, (3001, 3)), dtype=torch.float32, device=cuda_device)
    v = torch.as_tensor(rng.normal(size=(3001, 3)), dtype=torch.float32, device=cuda_device)
    one = yukawa.yukawa_field_cuda(q, p, v, 7.5)
    got = farfield._rowsharded(q, p, v, 7.5, device_mesh(devices=[cuda_device] * 4))
    torch.cuda.synchronize()
    assert torch.equal(got, one)
