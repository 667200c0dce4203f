"""Port paged-ELL SpMV (shm3d_torch.solve.pell) against shm3d.solve.pell.

The port's ``build_paged`` (real passes only, no compile-shape buckets) and
its plain version ``paged_matvec_torch`` are compared, in float32, with the
JAX package's ``matvec`` (its XLA path on the CPU) within 1e-6 x max|y| --
the same float32 products summed in another order -- and with SciPy in f64
within 1e-5 x max|y|, the float32 rounding of the values and of x.  The
CUDA kernel against the plain version runs only where a card is present
(marked ``cuda``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from shm3d.solve import pell as jpell
from shm3d_torch.solve import ell, pell
from shm3d_torch.utils import tree, treestore

torch.set_num_threads(2)

JAX_RTOL = 1e-6
SCIPY_RTOL = 1e-5
CASES = [
    (5000, 5000, 40000),      # square, multi-tile, multi-page
    (3000, 7000, 25000),      # rectangular wide
    (7000, 900, 25000),       # rectangular tall (single source page)
    (100, 100, 300),          # single tile
    (1, 1, 1),                # degenerate
]


def _rand_csr(rng, n, m, nnz):
    rows = rng.integers(0, n, nnz)
    cols = rng.integers(0, m, nnz)
    return sp.coo_matrix((rng.standard_normal(nnz), (rows, cols)), shape=(n, m)).tocsr()


def _multiplicity_csr(rng, n=2500):
    """Rows with many entries in one page: the multiplicity passes."""
    rows = np.repeat(np.arange(n), 9)
    cols = (rows + rng.integers(-40, 41, rows.size)) % n
    return sp.coo_matrix((rng.standard_normal(rows.size), (rows, cols)), shape=(n, n)).tocsr()


def _plain(P, x, n_out=None):
    return pell.paged_matvec_torch(ell.device_put_tree(P, "cpu"),
                                   torch.as_tensor(x), n_out).numpy()


def _check(A, x, y, yj=None):
    ref = A @ x.astype(np.float64)
    scale = max(np.abs(ref).max(), 1e-30)
    assert y.shape == ref.shape
    assert np.abs(y - ref).max() <= SCIPY_RTOL * scale
    if yj is not None:
        assert np.abs(y - yj).max() <= JAX_RTOL * scale


@pytest.mark.parametrize("n,m,nnz", CASES)
def test_plain_matches_jax_and_scipy(n, m, nnz):
    rng = np.random.default_rng(0)
    A = _rand_csr(rng, n, m, nnz)
    P = pell.build_paged(A, np.float32)
    assert P.nnz == A.nnz and P.n_rows == n and P.n_cols == m
    x = rng.standard_normal(m).astype(np.float32)
    yj = np.asarray(jpell.matvec(jpell.build_paged(A, np.float32), jnp.asarray(x)))
    _check(A, x, _plain(P, x), yj)
    # the port keeps the pass decomposition and drops only the padding
    assert P.n_passes <= jpell.build_paged(A, np.float32).n_passes
    np.testing.assert_array_equal(pell.to_scipy(P).toarray(), A.astype(np.float32).toarray())


def test_multiplicity_passes():
    rng = np.random.default_rng(1)
    A = _multiplicity_csr(rng)
    P = pell.build_paged(A, np.float32)
    # 9 entries in at most 2 pages per row: several passes per (tile, page)
    assert P.n_passes > 2 * (-(-A.shape[0] // pell.PAGE))
    x = rng.standard_normal(A.shape[1]).astype(np.float32)
    yj = np.asarray(jpell.matvec(jpell.build_paged(A, np.float32), jnp.asarray(x)))
    _check(A, x, _plain(P, x), yj)


@pytest.mark.parametrize("seg_tiles,seg_passes", [(2, 40), (2048, 26)])
def test_forced_segmentation_and_n_out(monkeypatch, seg_tiles, seg_passes):
    """Many segments, cut by the tile budget or by the pass budget (then
    at non-power-of-two spans), in both packages; ``n_out`` slices."""
    for mod in (pell, jpell):
        monkeypatch.setattr(mod, "_SEG_TILES", seg_tiles)
        monkeypatch.setattr(mod, "_SEG_PASSES", seg_passes)
    rng = np.random.default_rng(2)
    n = 11 * pell.PAGE
    rows = np.repeat(np.arange(n), 4)
    cols = (rows + rng.integers(-600, 601, rows.size)) % n
    A = sp.coo_matrix((rng.standard_normal(rows.size), (rows, cols)), shape=(n, n)).tocsr()
    P = pell.build_paged(A, np.float32)
    J = jpell.build_paged(A, np.float32)
    assert len(P.segs) > 2 and len(J.segs) > 2
    assert [s.t0 for s in P.segs] == [s.t0 for s in J.segs]
    x = rng.standard_normal(n).astype(np.float32)
    yj = np.asarray(jpell.matvec(J, jnp.asarray(x)))
    _check(A, x, _plain(P, x), yj)
    # the JAX package's padded segments overlap the next segment's tiles;
    # the port reads them as they are
    _check(A, x, _plain(tree.adopt(J), x), yj)
    k = n - 1500
    np.testing.assert_array_equal(_plain(P, x, n_out=k), _plain(P, x)[:k])


def test_empty_tiles_and_empty_matrix():
    A = sp.csr_matrix((np.ones(2), ([0, 2100], [5, 7])), shape=(2200, 2200))
    P = pell.build_paged(A, np.float32)
    y = _plain(P, np.ones(2200, np.float32))
    assert y[0] == 1.0 and y[2100] == 1.0 and np.count_nonzero(y) == 2
    Z = pell.build_paged(sp.csr_matrix((64, 64)), np.float32)
    assert np.all(_plain(Z, np.ones(64, np.float32)) == 0)


def test_apply_dispatches_on_operator_type():
    rng = np.random.default_rng(4)
    A = _rand_csr(rng, 4000, 4000, 20000)
    x = rng.standard_normal(4000)
    ref = A @ x
    for op in (pell.build_paged(A, np.float64), ell.build_ell(A, np.float64),
               ell.build_sliced(A, np.float64)):
        y = pell.apply(ell.device_put_tree(op, "cpu"), torch.as_tensor(x)).numpy()
        np.testing.assert_allclose(y, ref, rtol=0, atol=1e-12 * np.abs(ref).max())


def test_disk_form_roundtrip(tmp_path, monkeypatch):
    """The port's types go through the port's own treestore as tagged
    dicts, without touching its class registry."""
    monkeypatch.setenv("SHM3D_CACHE_DIR", str(tmp_path))
    rng = np.random.default_rng(5)
    A = _rand_csr(rng, 3000, 2000, 9000)
    P = pell.build_paged(A, np.float32)
    assert "PagedMat" not in treestore._REGISTRY
    treestore.save_tree(("pelltest_torch",), tree.to_plain(dict(P=P)))
    P2 = tree.from_plain(treestore.load_tree(("pelltest_torch",)))["P"]
    assert isinstance(P2, pell.PagedMat) and P2.nnz == P.nnz
    x = rng.standard_normal(2000).astype(np.float32)
    np.testing.assert_array_equal(_plain(P, x), _plain(P2, x))


def test_cuda_wrapper_refuses_cpu_tensors():
    """The kernel wrapper launches only on CUDA tensors; it never falls back
    to the plain version."""
    A = _rand_csr(np.random.default_rng(6), 100, 100, 300)
    P = ell.device_put_tree(pell.build_paged(A, np.float32), "cpu")
    before = pell.KERNEL_LAUNCHES
    with pytest.raises(ValueError, match="CUDA tensor"):
        pell.paged_matvec_cuda(P, torch.zeros(100))
    assert pell.KERNEL_LAUNCHES == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    from shm3d_torch._device import resolve_device

    return resolve_device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["random", "multiplicity", "segments", "jax_padded"])
def test_cuda_kernel_matches_plain(cuda_device, monkeypatch, case):
    """Kernel vs plain version on the card, float32, within 1e-5 x max|y|
    (float32 sums in another order)."""
    rng = np.random.default_rng(7)
    if case == "segments":
        monkeypatch.setattr(pell, "_SEG_PASSES", 26)
        monkeypatch.setattr(jpell, "_SEG_PASSES", 26)
    A = (_multiplicity_csr(rng) if case == "multiplicity"
         else _rand_csr(rng, 11 * pell.PAGE + 5, 7000, 90000))
    P = (tree.adopt(jpell.build_paged(A, np.float32)) if case == "jax_padded"
         else pell.build_paged(A, np.float32))
    Pd = ell.device_put_tree(P, cuda_device)
    x = torch.as_tensor(rng.standard_normal(A.shape[1]), dtype=torch.float32,
                        device=cuda_device)
    before = pell.KERNEL_LAUNCHES
    got = pell.apply(Pd, x)
    assert pell.KERNEL_LAUNCHES == before + len(P.segs)
    ref = pell.paged_matvec_torch(Pd, x)
    torch.cuda.synchronize()
    assert got.shape == ref.shape == (A.shape[0],)
    err = (got - ref).abs().max().item()
    assert err <= 1e-5 * ref.abs().max().item(), err
