"""float64 through the port: K1's float64 instantiation and the float64
paths that run on it.

On the CPU the wrappers take K1's plain versions; they are held in float64
to ``shm3d.ops.yukawa.yukawa_field_xla`` under x64 at the float64 kernel's
query block and chunk granularity (1e-12: one formula in one precision,
regrouped), and the dtype-dependent shape logic around the kernel (query
blocks, the row split of ``farfield._rowsharded``) is checked directly.
Whole float64 solves through ``SignedHeatSolver(..., device="cpu")`` and on
4 CPU shards are held to shm3d's under x64 within 1e-8 relative (the same
AMG or MG-preconditioned CG to 1e-10 in another summation order, as
tests/test_torch_grid.py and tests/test_torch_cr.py hold them), and the
CLI's ``--dtype float64`` to the API's phi.

The ``cuda`` tests run where a card is present (``python -m pytest -m cuda
tests/test_torch_f64.py`` on the GPU machine; ``chip_smoke.py`` phase 20
runs the same checks at the main path's shapes): the float64 kernel against
its plain version within 1e-12 relative per row, float64 solves on the card
within 1e-8 of the CPU's, and the float64 ring on 4 shards of one card."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shm3d import parallel as jpar
from shm3d.api import SignedHeatSolver as JaxSolver
from shm3d.ops.yukawa import yukawa_field_xla
from shm3d_torch import SignedHeatSolver
from shm3d_torch.config import SignedHeatOptions
from shm3d_torch.geometry import sources as src_mod
from shm3d_torch.geometry.procedural import make_icosphere, make_sphere_cloud
from shm3d_torch.io.mesh_io import read_geometry
from shm3d_torch.ops import farfield, yukawa
from shm3d_torch.parallel import device_mesh, yukawa_field_ring
from torch_interop import jax_geom, jax_options

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUNNY = os.path.join(REPO, "tests", "data", "bunny_dec.obj")
F64 = SignedHeatOptions(dtype="float64", refine_steps=0, disk_cache=False)


def _t(a, dtype=torch.float64, device="cpu"):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def src1280():
    """(points, vectors) of a 1,280-face icosphere: five 256-source chunks."""
    s = src_mod.from_mesh(make_icosphere(3))
    return s.points, s.vectors()


# --- the dtype-dependent shape logic -------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_query_block_and_row_split(dtype):
    block = yukawa.query_block(dtype)
    assert block == 1024
    for n_rows, P in ((211_563, 4), (35_937, 4), (5_000, 3), (1_000, 4)):
        step = farfield.row_blocks(n_rows, P, dtype)
        assert step % block == 0 and step * P >= n_rows and (step - block) * P < n_rows


def test_query_block_refuses_other_dtypes():
    for dtype in (torch.float16, torch.bfloat16, torch.int32):
        with pytest.raises(TypeError, match="float32 or float64"):
            yukawa.query_block(dtype)
        with pytest.raises(TypeError, match="float32 or float64"):
            farfield.row_blocks(5000, 4, dtype)


def test_rowsharded_f64_is_bitwise_one_call(src1280):
    """``_rowsharded`` in float64 on 4 CPU shards (rows split at the
    float64 query block, 5,000 rows: blocks of 2,048, 2,048 and 904) equals
    one unsplit plain call bit for bit, and both lie within 1e-12 of
    shm3d's float64 field."""
    pts, vecs = src1280
    q = np.random.default_rng(1).uniform(-1.5, 1.5, (5000, 3))
    mesh = device_mesh(devices=["cpu"] * 4)
    got = farfield._rowsharded(_t(q), _t(pts), _t(vecs), 6.0, mesh)
    one = yukawa.yukawa_field(_t(q), _t(pts), _t(vecs), 6.0)
    assert torch.equal(got, one)
    ref = np.asarray(yukawa_field_xla(jnp.asarray(q), jnp.asarray(pts), jnp.asarray(vecs), 6.0))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("normalize", [True, False])
def test_partials_at_f64_block_match_xla(src1280, normalize):
    """The plain partials and merge in float64 across a float64 query block
    (1,154 rows = one block + 130) and at the kernel's chunk granularity
    (256 sources: five chunks, the last one ragged), against
    ``yukawa_field_xla`` under x64, 1e-12."""
    pts, vecs = src1280
    Q = yukawa.query_block(torch.float64) + 130
    q = np.random.default_rng(2).uniform(-2, 2, (Q, 3))
    part = yukawa.yukawa_partials(_t(q), _t(pts), _t(vecs), 3.1, 256)
    assert part.shape == (5, Q, 4) and part.dtype == torch.float64
    got = yukawa.yukawa_merge(part, normalize=normalize).numpy()
    ref = np.asarray(yukawa_field_xla(jnp.asarray(q), jnp.asarray(pts), jnp.asarray(vecs),
                                      3.1, normalize=normalize))
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12 * np.abs(ref).max())


# --- the wrappers' refusals ----------------------------------------------

def _launches():
    return (yukawa.KERNEL_LAUNCHES, yukawa.PARTIAL_LAUNCHES, yukawa.MERGE_LAUNCHES,
            yukawa.KERNEL_LAUNCHES_F64, yukawa.PARTIAL_LAUNCHES_F64,
            yukawa.MERGE_LAUNCHES_F64)


@pytest.mark.parametrize("case", ["cpu_f64", "cpu_f32", "mixed", "float16"])
def test_wrappers_refuse_without_launching(case, src1280):
    """CPU tensors of either kernel dtype (ValueError: the kernel launches
    on CUDA tensors only, never the plain version), float64 queries with
    float32 sources, and float16 (TypeError, before any device check)."""
    pts, vecs = src1280
    dtype = {"cpu_f64": torch.float64, "cpu_f32": torch.float32, "mixed": torch.float64,
             "float16": torch.float16}[case]
    q, p, v = _t(pts[:8], dtype), _t(pts, dtype), _t(vecs, dtype)
    if case == "mixed":
        p = p.float()
    err, match = ((ValueError, "CUDA tensor") if case.startswith("cpu")
                  else (TypeError, "src_points" if case == "mixed" else "float32 or float64"))
    before = _launches()
    with pytest.raises(err, match=match):
        yukawa.yukawa_field_cuda(q, p, v, 1.0)
    with pytest.raises(err, match=match):
        yukawa.yukawa_partials_cuda(q, p, v, 1.0, 256)
    with pytest.raises(TypeError, match="CUDA device"):
        yukawa.yukawa_merge_cuda(torch.zeros((1, 8, 4), dtype=dtype))
    assert _launches() == before


# --- whole float64 solves on the CPU against shm3d -----------------------

def _cases():
    ico = make_icosphere(2)
    cloud = make_sphere_cloud(2000)
    return {
        "grid_dense": ("grid", ico, F64.with_(step1_method="dense"), None),
        "grid_shell": ("grid", cloud, F64.with_(h_coef=1.0, step1_method="shell"), None),
        "grid_greedy": ("grid", ico, F64.with_(fast_integration=True), None),
        "tet_cr": ("tet", ico, F64, None),
        "tet_vertex": ("tet", ico, F64.with_(use_crouzeix_raviart=False), None),
        "grid_4_shards": ("grid", ico, F64.with_(h_coef=1.0, step1_method="dense"), 4),
        "tet_4_shards": ("tet", ico, F64, 4),
    }


@pytest.mark.parametrize("case", list(_cases()))
def test_api_f64_matches_shm3d(case):
    """float64 through the port's public entry point, on the CPU or on 4 CPU
    shards, against shm3d's under x64 (4 of the conftest's virtual devices
    for the shards): phi within 1e-8 relative."""
    domain, geom, opts, shards = _cases()[case]
    if shards:
        solver = SignedHeatSolver(domain, mesh=device_mesh(devices=["cpu"] * shards))
        jsolver = JaxSolver(domain, mesh=jpar.device_mesh(shards))
    else:
        solver, jsolver = SignedHeatSolver(domain, device="cpu"), JaxSolver(domain)
    got = solver.compute_distance(geom, opts)
    want = jsolver.compute_distance(jax_geom(geom), jax_options(opts))
    assert np.asarray(got.phi).dtype == np.float64 and np.isfinite(got.phi).all()
    assert _rel(np.asarray(got.phi), np.asarray(want.phi)) <= 1e-8
    if shards:
        assert solver.last_stats["mesh"]["shape"] == [shards]


def test_cli_f64_writes_the_api_phi(tmp_path):
    """``python -m shm3d_torch.cli --grid --dtype float64 --device cpu``
    writes the phi of ``SignedHeatSolver("grid", device="cpu")`` at the
    same options (1e-12: the subprocess may run torch on more threads)."""
    phi_path = tmp_path / "phi.npy"
    out = subprocess.run(
        [sys.executable, "-m", "shm3d_torch.cli", BUNNY, "--grid", "--dtype", "float64",
         "--device", "cpu", "--no-disk-cache", "--export-phi", str(phi_path)],
        capture_output=True, text=True, cwd=REPO, timeout=300,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr[-2000:]
    got = np.load(phi_path)
    want = SignedHeatSolver("grid", device="cpu").compute_distance(
        read_geometry(BUNNY), SignedHeatOptions(dtype="float64", disk_cache=False)).phi
    assert got.shape == want.shape and got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())


# --- on the card ---------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    from shm3d_torch._device import resolve_device

    return resolve_device("cuda")


def _row_rel(got, ref):
    """max over rows of max |got - ref| / max |ref| in the row; a row equal
    to its reference counts 0 (far from every source an unnormalized sum
    underflows to 0 even in float64)."""
    diff = (got - ref).abs().amax(dim=1)
    return torch.where(diff == 0, 0.0, diff / ref.abs().amax(dim=1)).max().item()


def _kernel_inputs(case, device):
    rng = np.random.default_rng(20)
    n = rng.normal(size=(3001, 3))
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    v = n * rng.uniform(0.5, 1.5, (3001, 1))
    if case == "ragged":
        q, p, v, lam = rng.uniform(-1, 1, (5003, 3)), rng.uniform(-1, 1, (4099, 3)), \
            rng.normal(size=(4099, 3)) * 0.3 + [0, 0, 1], 7.5
    elif case == "coincident":
        q, p, lam = n[:257], n, 10.0
    elif case == "far":
        q, p, lam = 40.0 * n[:1000] * [1, -1, 1], n, 50.0
    else:  # padded: far, zero-weight sources to a multiple of 1024
        q, p, lam = rng.uniform(-1, 1, (777, 3)), n, 3.0
    q, p, v = (_t(a, device=device) for a in (q, p, v))
    if case == "padded":
        p, v = yukawa.pad_sources(p, v, 1024)
    return q, p, v, lam


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ragged", "coincident", "far", "padded"])
@pytest.mark.parametrize("normalize", [True, False])
def test_cuda_f64_kernel_matches_plain(cuda_device, case, normalize):
    """The float64 instantiation against its float64 plain version, fused
    and split (partials then merge, bitwise equal to the fused call): within
    1e-12 relative per row, one float64 count a call and no float32 one.
    Far queries (|q| = 40, lam = 50) underflow exp(-lam r) to 0 even in
    float64; the reference keeps them finite and of unit norm."""
    q, p, v, lam = _kernel_inputs(case, cuda_device)
    before = _launches()
    got = yukawa.yukawa_field(q, p, v, lam, normalize=normalize)
    chunk = yukawa.yukawa_chunk_len(q.shape[0], p.shape[0], cuda_device, torch.float64)
    split = yukawa.yukawa_merge(yukawa.yukawa_partials(q, p, v, lam, chunk), normalize)
    ref = yukawa.yukawa_field_torch(q, p, v, lam, normalize=normalize)
    torch.cuda.synchronize()
    after = _launches()
    assert after[:3] == before[:3] and tuple(
        a - b for a, b in zip(after[3:], before[3:])) == (1, 1, 1)
    assert got.dtype == torch.float64 and torch.isfinite(got).all()
    assert torch.equal(split, got)
    assert _row_rel(got, ref) <= 1e-12


@pytest.mark.cuda
def test_cuda_f64_ring_on_four_shards(cuda_device, src1280):
    """The float64 ring on 4 shards of one card: 1 x 4 and 2 x 2 bit for
    bit, within 1e-12 relative per row of the plain ring on the CPU shards
    at the kernel's chunking (the partials merge in one order)."""
    pts, vecs = src1280
    q = np.random.default_rng(3).uniform(-1.5, 1.5, (6000, 3))
    args = [_t(a, device=cuda_device) for a in (q, pts, vecs)]
    flat = yukawa_field_ring(*args, 5.0, device_mesh(devices=[cuda_device] * 4)).gather()
    hier = yukawa_field_ring(*args, 5.0, device_mesh(devices=[cuda_device] * 4,
                                                     n_slices=2)).gather()
    ref = torch.as_tensor(yukawa_field_xla(jnp.asarray(q), jnp.asarray(pts),
                                           jnp.asarray(vecs), 5.0)).to(cuda_device)
    torch.cuda.synchronize()
    assert flat.dtype == torch.float64 and torch.equal(flat, hier)
    assert _row_rel(flat, ref) <= 1e-12


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["grid16", "bunny_cr"])
def test_cuda_f64_solve_matches_cpu(cuda_device, case):
    """A float64 solve on the card against the same solve on the CPU:
    within 1e-8 relative (the same AMG or MG-CG to 1e-10 in another
    summation order, the bound the CPU tests hold against shm3d), with K1's
    float64 kernel launched and its float32 one not."""
    if case == "grid16":
        domain, geom = "grid", make_icosphere(2)
    else:
        domain, geom = "tet", read_geometry(BUNNY)
    before = _launches()
    got = SignedHeatSolver(domain, device=cuda_device).compute_distance(geom, F64).phi
    after = _launches()
    want = SignedHeatSolver(domain, device="cpu").compute_distance(geom, F64).phi
    assert after[0] == before[0] and after[3] == before[3] + 1  # 16^3: the dense Step 1
    assert np.isfinite(got).all()
    assert _rel(np.asarray(got), np.asarray(want)) <= 1e-8
