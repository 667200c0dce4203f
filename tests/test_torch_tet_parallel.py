"""The port's multi-device tet solve (``SignedHeatTetSolver(mesh=)``) on
meshes of CPU shards in one process, against shm3d's mesh solve on the 8
virtual CPU devices tests/conftest.py gives JAX and against the port's own
single-device solve.  Inputs are numpy arrays and the port's procedural and
file geometry, carried to the JAX package with tests/torch_interop.py; float64
unless a case says otherwise.

- ``parallel.rows``: the sliced-ELL operators are split by rows, each
  block's rows computed by the unsplit operator's code in its order, so a
  split product, and a V-cycle over split levels, equal the unsplit ones
  bit for bit (2, 3 and 8 shards; a ragged last block); the plain
  encodings stay whole on the first device.
- Step 3 given one Y: the mesh keeps the vectors whole on its first device
  and splits only the sliced-ELL operators, so CR, the vertex path in each
  mode and greedy integration equal one device's bit for bit (float32 with
  the face operator and the AMG levels stored paged at this size, as at
  production sizes).
- Whole solves: the ring Step 1 sums the sources in another order, so they
  are held to tests/test_parallel.py's tolerances for the same properties
  (icosphere 1e-12, bunny_dec CR 1e-6, a 2 x 4 mesh 1e-10).
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from shm3d import parallel as jpar
from shm3d.tet.solver import SignedHeatTetSolver as JaxTetSolver
from shm3d_torch import SignedHeatSolver
from shm3d_torch.config import LevelSetConstraint, SignedHeatOptions
from shm3d_torch.geometry.procedural import make_icosphere
from shm3d_torch.io.mesh_io import read_geometry
from shm3d_torch.parallel import RowSharded, device_mesh, rows
from shm3d_torch.solve import amg, ell, pell
from shm3d_torch.tet import cr_solver
from shm3d_torch.tet.solver import SignedHeatTetSolver
from shm3d_torch.utils.timing import PhaseTimer
from torch_interop import jax_geom, jax_options

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUNNY = os.path.join(REPO, "tests", "data", "bunny_dec.obj")
F64 = SignedHeatOptions(dtype="float64", disk_cache=False)
TORCH_DTYPE = {np.float32: torch.float32, np.float64: torch.float64}


def cpu_mesh(n, n_slices=1):
    return device_mesh(devices=["cpu"] * n, n_slices=n_slices)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# --- row-sharded operators ------------------------------------------------


def _skewed(n, m, seed):
    """A sparse (n, m) matrix whose row widths span 0..40 (empty rows too)."""
    rng = np.random.default_rng(seed)
    widths = np.minimum(rng.geometric(0.15, n) - 1, 40)
    widths[rng.choice(n, 7, replace=False)] = 0
    r = np.repeat(np.arange(n), widths)
    c = rng.integers(0, m, r.size)
    return sp.coo_matrix((rng.standard_normal(r.size), (r, c)), shape=(n, m)).tocsr()


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("P", [2, 3, 8])
def test_row_sharded_matvec_is_bitwise(P, dtype):
    n, m = 32 * 8 * 3 + 17, 700          # the last block ragged
    A = _skewed(n, m, seed=P)
    host = pell.sell_from_csr(A, dtype)
    whole = ell.device_put_tree(host, "cpu")
    split = ell.device_put_tree(host, "cpu", cpu_mesh(P))
    assert isinstance(split, RowSharded)
    assert len(split.blocks) == P and sum(split.block_rows) == n
    assert split.block_rows[-1] % 32 != 0
    x = torch.as_tensor(np.random.default_rng(1).standard_normal(m), dtype=TORCH_DTYPE[dtype])
    before = (rows.ROW_BLOCK_LAUNCHES, rows.BROADCASTS)
    y = pell.apply(split, x, n_out=n)
    assert (rows.ROW_BLOCK_LAUNCHES, rows.BROADCASTS) == (before[0] + P, before[1] + 1)
    assert torch.equal(y, pell.apply(whole, x, n_out=n))
    assert torch.equal(pell.apply(split, x, n_out=n - 5), pell.apply(whole, x, n_out=n - 5))
    np.testing.assert_allclose(y.numpy(), A @ x.numpy().astype(np.float64),
                               rtol=1e-5 if dtype == np.float32 else 1e-12, atol=1e-4)


@pytest.mark.parametrize("kind", ["small", "ell", "sliced"])
def test_what_a_mesh_keeps_whole(kind):
    """Fewer than 32 rows a shard, and the plain encodings at any size, stay
    whole on the first device (their row sums are torch's reduction, whose
    order on CUDA follows the panel's shape); vectors go there too."""
    A = _skewed(32 * 4 - 1 if kind == "small" else 4000, 50, seed=3)
    host = {"small": pell.sell_from_csr(A, np.float64),
            "ell": ell.build_ell(A, np.float64),       # a COO tail, folded at upload
            "sliced": ell.build_sliced(A, np.float64)}[kind]
    tree = ell.device_put_tree(dict(S=host, v=np.ones(3)), "cpu", cpu_mesh(4))
    assert type(tree["S"]) is type(host) and rows.block_rows(tree["S"]) is None
    assert tree["v"].device == torch.device("cpu")
    x = torch.as_tensor(np.random.default_rng(4).standard_normal(50))
    assert torch.equal(pell.apply(tree["S"], x, n_out=A.shape[0]),
                       pell.apply(ell.device_put_tree(host, "cpu"), x, n_out=A.shape[0]))
    with pytest.raises(ValueError, match="first device"):
        ell.device_put_tree(dict(v=np.ones(3)), "meta", cpu_mesh(2))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_split_hierarchy_vcycle_is_bitwise(dtype, monkeypatch):
    """amg.hierarchy_to_device(mesh=): the level operators stored paged
    (float32) and large enough are split, the rest stays whole (every level
    in float64); the V-cycle equals the unsplit one bit for bit."""
    k = 18
    lap1 = sp.diags([-np.ones(k - 1), 2.0 * np.ones(k), -np.ones(k - 1)], [-1, 0, 1])
    eye = sp.identity(k)
    H = (sp.kron(sp.kron(lap1, eye), eye) + sp.kron(sp.kron(eye, lap1), eye)
         + sp.kron(sp.kron(eye, eye), lap1) + 1e-2 * sp.identity(k ** 3)).tocsr()
    h = amg.build_hierarchy_host(H, dtype, max_coarse=40,
                                 paged_min_nnz=0 if dtype == np.float32 else None)
    mesh = cpu_mesh(4)
    h1 = amg.hierarchy_to_device(h, "cpu")
    h4 = amg.hierarchy_to_device(h, "cpu", mesh)
    whole_from = rows.first_whole_level(h4.levels, None)
    split = [i for i, lvl in enumerate(h4.levels) if isinstance(lvl.A, RowSharded)]
    if dtype == np.float32:
        assert split == list(range(whole_from)) and 1 <= whole_from < len(h4.levels)
    else:
        assert split == [] and whole_from == 0
    assert not any(isinstance(o, RowSharded) for lvl in h4.levels for o in (lvl.P, lvl.PT))
    assert h4.coarse_inv.device == torch.device("cpu")
    b = torch.as_tensor(np.random.default_rng(2).standard_normal(k ** 3),
                        dtype=TORCH_DTYPE[dtype])
    assert torch.equal(amg.make_preconditioner(h1)(b), amg.make_preconditioner(h4)(b))


# --- whole solves -----------------------------------------------------------


def test_icosphere_ring_matches_shm3d_and_one_device():
    """Counterpart of tests/test_parallel.py's ring test: the port's 8-shard
    mesh against shm3d's SignedHeatTetSolver(mesh=device_mesh(8)) and the
    port's one device (the ring sums the sources in another order)."""
    assert len(jax.devices()) >= 8, "conftest must force 8 virtual CPU devices"
    geom = make_icosphere(1)
    solver = SignedHeatTetSolver(mesh=cpu_mesh(8))
    got = solver.compute_distance(geom, F64).phi
    stats = solver.last_stats
    assert stats["step3_path"] == "crouzeix-raviart"
    assert stats["mesh"]["step1"] == "ring" and stats["mesh"]["shape"] == [8]
    # float64: nothing in the sliced-ELL encoding, every operator whole
    assert stats["mesh"]["row_blocks"] == {"L": None, "P": None}
    single = SignedHeatTetSolver(device="cpu").compute_distance(geom, F64).phi
    ref = JaxTetSolver(mesh=jpar.device_mesh(8)).compute_distance(
        jax_geom(geom), jax_options(F64)).phi
    assert _rel(got, single) <= 1e-12
    assert _rel(got, ref) <= 1e-12


def test_bunny_cr_mesh_matches_one_device(tmp_path, monkeypatch):
    """Counterpart of tests/test_parallel.py's sharded CR test on bunny_dec:
    the mesh solve takes the CR path within 1e-6 of one device's (both
    converge only to solver_tol).  The mesh solver reads the one-device
    solver's disk artifact."""
    monkeypatch.setenv("SHM3D_CACHE_DIR", str(tmp_path))
    geom = read_geometry(BUNNY)
    opts = F64.with_(disk_cache=True)
    single = SignedHeatTetSolver(device="cpu").compute_distance(geom, opts)
    assert single.mesh.conforming
    solver = SignedHeatTetSolver(mesh=cpu_mesh(8))
    got = solver.compute_distance(geom, opts)
    stats = solver.last_stats
    assert stats["step3_path"] == "crouzeix-raviart" and stats["mesh"]["shape"] == [8]
    assert _rel(got.phi, single.phi) < 1e-6


def test_multislice_matches_one_device_and_1d():
    """Counterpart of tests/test_parallel.py's 2-slice tet test: a 2 x 4
    mesh within 1e-10 of one device, and bit for bit the 1 x 8 mesh's phi
    (the ring merges in the sources' home order; the same row blocks)."""
    geom = make_icosphere(1)
    multi = SignedHeatTetSolver(mesh=cpu_mesh(8, n_slices=2))
    phi = multi.compute_distance(geom, F64).phi
    assert multi.last_stats["mesh"]["axis_names"] == ["s", "d"]
    single = SignedHeatTetSolver(device="cpu").compute_distance(geom, F64).phi
    flat = SignedHeatTetSolver(mesh=cpu_mesh(8)).compute_distance(geom, F64).phi
    assert _rel(phi, single) <= 1e-10
    assert np.array_equal(phi, flat)


# --- Step 3 given one Y -----------------------------------------------------


@pytest.fixture(scope="module")
def f32_pair():
    """A one-device and a 4-shard solver over one icosphere, float32, with
    the encodings of production sizes forced (the CR operator and the AMG
    levels stored paged), and one Y from the one device."""
    mp = pytest.MonkeyPatch()
    mp.setattr(cr_solver, "PAGED_MIN_NNZ", 0)
    geom = make_icosphere(2)
    opts = SignedHeatOptions(dtype="float32", disk_cache=False)
    one = SignedHeatTetSolver(device="cpu")
    res = one.compute_distance(geom, opts)
    mesh_solver = SignedHeatTetSolver(mesh=cpu_mesh(4))
    mesh_solver.compute_distance(geom, opts)
    yield geom, opts, one, mesh_solver, torch.as_tensor(res.Y, dtype=torch.float32)
    mp.undo()


def _cached(solver):
    return next(iter(solver._cache.values()))


@pytest.mark.parametrize("case", ["cr", "zero_set", "none", "multiple", "greedy"])
def test_step3_given_one_y_is_bitwise(f32_pair, case):
    geom, opts, one, mesh_solver, Y = f32_pair
    c1, c4 = _cached(one), _cached(mesh_solver)
    if case == "cr":
        assert isinstance(c4["cr_path"].arrays["L"], RowSharded)
        out = []
        for c in (c1, c4):
            phi = c["cr_path"].integrate(Y, opts, src_face_components=c["cr_face_components"],
                                         src_face_areas=c["cr_face_areas"])
            out.append((phi, c["cr_path"].last_stats))
    elif case == "greedy":
        out = [(s._greedy(c["mesh"], Y.numpy().astype(np.float64), c, opts), {})
               for s, c in ((one, c1), (mesh_solver, c4))]
    else:
        o = opts.with_(use_crouzeix_raviart=False,
                       level_set_constraint=LevelSetConstraint[case.upper()])
        out = []
        for s, c in ((one, c1), (mesh_solver, c4)):
            s.last_stats = {}
            phi = s._integrate(Y, c["mesh"], c, o, PhaseTimer(s.device))
            out.append((phi, dict(s.last_stats)))
        assert isinstance(c4["H_ell"], RowSharded)
    (a, sa), (b, sb) = out
    assert np.array_equal(a, b) and np.isfinite(a).all()
    for key in ("iters", "residual", "refine_pass_rels", "proj_iters", "proj_residual"):
        assert sa.get(key) == sb.get(key), key


def test_mesh_stats_and_device_checks(f32_pair):
    geom, opts, _, mesh_solver, _ = f32_pair
    mesh_solver.compute_distance(geom, opts)
    st = mesh_solver.last_stats["mesh"]
    assert st["step1"] == "ring" and st["devices"] == ["cpu"] * 4
    assert len(st["row_blocks"]["L"]) == 4 and st["amg_first_whole_level"] >= 1
    with pytest.raises(ValueError, match="first device"):
        SignedHeatTetSolver(device="meta", mesh=cpu_mesh(2))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            SignedHeatTetSolver(mesh=device_mesh(devices=["cuda:0", "cuda:0"]))


def test_mesh_reads_one_device_artifact_and_upgrades(tmp_path, monkeypatch):
    """A mesh solver reads the artifact a one-device solver wrote (the disk
    key is the one device's) and gives a fresh mesh solve's phi bit for bit;
    the mode upgrades work on a mesh (greedy -> CR, CR -> vertex)."""
    monkeypatch.setenv("SHM3D_CACHE_DIR", str(tmp_path))
    geom = make_icosphere(1)
    cached_opts = F64.with_(disk_cache=True)
    SignedHeatTetSolver(device="cpu").compute_distance(geom, cached_opts.with_(
        fast_integration=True))
    mesh_solver = SignedHeatTetSolver(mesh=cpu_mesh(4))
    upgraded = mesh_solver.compute_distance(geom, cached_opts)
    assert any("mode upgrade" in p for p in mesh_solver.last_stats["phases"])
    assert len([p for p in tmp_path.iterdir() if p.name.startswith("tree_")]) == 1
    loaded = SignedHeatTetSolver(mesh=cpu_mesh(4)).compute_distance(geom, cached_opts)
    fresh = SignedHeatTetSolver(mesh=cpu_mesh(4)).compute_distance(geom, F64)
    assert np.array_equal(upgraded.phi, fresh.phi) and np.array_equal(loaded.phi, fresh.phi)
    vopts = cached_opts.with_(use_crouzeix_raviart=False)
    vertex = mesh_solver.compute_distance(geom, vopts)
    assert mesh_solver.last_stats["step3_path"] == "vertex"
    one = SignedHeatTetSolver(device="cpu").compute_distance(geom, vopts.with_(disk_cache=False))
    assert _rel(vertex.phi, one.phi) <= 1e-12


def test_dryrun_tet_on_cpu_shards():
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-m", "shm3d_torch.dryrun", "--devices", "4",
                          "--device", "cpu"], capture_output=True, text=True, env=env,
                         cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert summary["tet"]["step3_path"] == "crouzeix-raviart"
    assert summary["tet"]["mesh"]["step1"] == "ring" and summary["mesh2d_equal"] is True


# --- on the card -------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    from shm3d_torch._device import resolve_device

    return resolve_device("cuda")


@pytest.mark.cuda
def test_cuda_row_blocks_match_one_launch(cuda_device):
    """K2 on the row blocks of a sliced-ELL operator whose blocks do not
    divide evenly: one launch a block, concatenated bitwise equal to one
    launch over the whole operator."""
    A = _skewed(32 * 1001 + 13, 20_000, seed=4)
    host = pell.sell_from_csr(A, np.float32)
    mesh = device_mesh(devices=[cuda_device] * 4)
    whole = ell.device_put_tree(host, cuda_device)
    split = ell.device_put_tree(host, cuda_device, mesh)
    assert len(set(split.block_rows)) > 1
    x = torch.as_tensor(np.random.default_rng(5).standard_normal(A.shape[1]),
                        dtype=torch.float32, device=cuda_device)
    before = pell.KERNEL_LAUNCHES
    y = pell.apply(split, x)
    assert pell.KERNEL_LAUNCHES == before + 4
    assert torch.equal(y, pell.apply(whole, x))


@pytest.mark.cuda
def test_cuda_ring_at_barycenter_shape(cuda_device):
    """The ring at a barycenter-like shape (many queries, a few hundred
    sources) within 1e-4 of K1 in one launch; 1 x 4 = 2 x 2 bit for bit."""
    from shm3d_torch.ops import yukawa
    from shm3d_torch.parallel import yukawa_field_ring

    rng = np.random.default_rng(6)
    q = torch.as_tensor(rng.uniform(-1, 1, (200_003, 3)), dtype=torch.float32,
                        device=cuda_device)
    p = torch.as_tensor(rng.uniform(-1, 1, (701, 3)), dtype=torch.float32, device=cuda_device)
    v = rng.normal(size=(701, 3)) * 0.3
    v[:, 2] += 1.0
    v = torch.as_tensor(v, dtype=torch.float32, device=cuda_device)
    flat = yukawa_field_ring(q, p, v, 9.0, device_mesh(devices=[cuda_device] * 4)).gather()
    hier = yukawa_field_ring(q, p, v, 9.0, device_mesh(devices=[cuda_device] * 4,
                                                       n_slices=2)).gather()
    one = yukawa.yukawa_field_cuda(q, p, v, 9.0)
    torch.cuda.synchronize()
    assert torch.equal(flat, hier)
    assert (flat - one).abs().max().item() <= 1e-4


@pytest.mark.cuda
def test_cuda_mesh_step3_given_one_y_is_bitwise(cuda_device, monkeypatch):
    """A small tet solve on 4 shards of the card (the CR operator and the
    AMG levels stored paged, as at production sizes): its CR Step 3 and
    vertex Step 3, given the one device's Y, equal the one device's bit for
    bit."""
    monkeypatch.setattr(cr_solver, "PAGED_MIN_NNZ", 0)
    geom = make_icosphere(2)
    opts = SignedHeatOptions(dtype="float32", disk_cache=False)
    one = SignedHeatTetSolver(device=cuda_device)
    res = one.compute_distance(geom, opts)
    mesh_solver = SignedHeatTetSolver(mesh=device_mesh(devices=[cuda_device] * 4))
    mesh_solver.compute_distance(geom, opts)
    Y = torch.as_tensor(res.Y, dtype=torch.float32, device=cuda_device)
    c1, c4 = _cached(one), _cached(mesh_solver)
    assert isinstance(c4["cr_path"].arrays["L"], RowSharded)
    a, b = (c["cr_path"].integrate(Y, opts, src_face_components=c["cr_face_components"],
                                   src_face_areas=c["cr_face_areas"]) for c in (c1, c4))
    assert np.array_equal(a, b)
    vopts = opts.with_(use_crouzeix_raviart=False)
    a, b = (s._integrate(Y, c["mesh"], c, vopts, PhaseTimer(s.device))
            for s, c in ((one, c1), (mesh_solver, c4)))
    assert isinstance(c4["H_ell"], RowSharded)
    assert np.array_equal(a, b)
