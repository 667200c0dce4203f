"""Port paged-ELL operators and the sliced-ELL SpMV (shm3d_torch.solve.pell)
against shm3d.solve.pell.

The port's ``build_paged`` (real passes only, no compile-shape buckets) and
its pass-semantics plain version ``paged_matvec_torch`` are compared, in
float32, with the JAX package's ``matvec`` (its XLA path on the CPU) within
1e-6 x max|y| -- the same float32 products summed in another order -- and
with SciPy in f64 within 1e-5 x max|y|, the float32 rounding of the values
and of x.  The device form, the SellMat that ``ell.device_put_tree`` makes
of a PagedMat (the port's or the JAX package's, padding included), is held
by its plain version ``sell_matvec_torch`` to the same bounds, and in
float64 to SciPy within 1e-12 x max|y|.  The CUDA kernel against the plain
version runs only where a card is present (marked ``cuda``)."""

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
F64_RTOL = 1e-12
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


def _tensors(op):
    """The operator's own leaves as CPU tensors (no device conversion)."""
    return tree.map_arrays(lambda a: ell.to_tensor(a, "cpu"), op)


def _plain(P, x, n_out=None):
    """The pass semantics, on the PagedMat's own leaves as tensors."""
    return pell.paged_matvec_torch(_tensors(P),
                                   torch.as_tensor(x), n_out).numpy()


def _sell(P, x, n_out=None):
    """The device form's plain version, after the upload's conversion."""
    S = ell.device_put_tree(P, "cpu")
    assert isinstance(S, pell.SellMat)
    return pell.sell_matvec_torch(S, torch.as_tensor(x), n_out).numpy()


def _check(A, x, y, yj=None, rtol=SCIPY_RTOL):
    ref = A @ x.astype(np.float64)
    scale = max(np.abs(ref).max(), 1e-30)
    assert y.shape == ref.shape
    assert np.abs(y - ref).max() <= rtol * scale
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


def _sell_case(case, rng, monkeypatch, dtype=np.float32):
    """(matrix, PagedMat in ``dtype``) of one of the layouts the conversion
    must take."""
    if case == "random":
        A = _rand_csr(rng, 5000, 7000, 40000)
    elif case == "multiplicity":
        A = _multiplicity_csr(rng)
    elif case == "segments":
        for mod in (pell, jpell):
            monkeypatch.setattr(mod, "_SEG_PASSES", 26)
        n = 11 * pell.PAGE + 5
        rows = np.repeat(np.arange(n), 4)
        cols = (rows + rng.integers(-600, 601, rows.size)) % n
        A = sp.coo_matrix((rng.standard_normal(rows.size), (rows, cols)),
                          shape=(n, n)).tocsr()
    elif case == "empty":
        # empty rows, whole empty slices and tiles, a rectangular shape
        A = sp.csr_matrix((rng.standard_normal(3), ([0, 40, 2100], [5, 7, 4999])),
                          shape=(2200, 5000))
    else:  # "jax_padded"
        A = _rand_csr(rng, 11 * pell.PAGE + 5, 7000, 90000)
    if case == "jax_padded":
        return A, tree.adopt(jpell.build_paged(A, dtype))
    return A, pell.build_paged(A, dtype)


SELL_CASES = ["random", "multiplicity", "segments", "empty", "jax_padded"]


@pytest.mark.parametrize("case", SELL_CASES)
def test_sell_matches_jax_and_scipy(monkeypatch, case):
    """The upload's SellMat of the port's and the JAX package's paged trees:
    float32 against the JAX package's matvec and SciPy, float64 against
    SciPy."""
    rng = np.random.default_rng(8)
    A, P = _sell_case(case, rng, monkeypatch)
    x = rng.standard_normal(A.shape[1]).astype(np.float32)
    J = jpell.build_paged(A, np.float32)
    yj = np.asarray(jpell.matvec(J, jnp.asarray(x)))[:A.shape[0]]
    _check(A, x, _sell(P, x), yj)
    A64, P64 = _sell_case(case, rng, monkeypatch, np.float64)
    x64 = rng.standard_normal(A64.shape[1])
    _check(A64, x64, _sell(P64, x64), rtol=F64_RTOL)
    k = A.shape[0] - 7
    np.testing.assert_array_equal(_sell(P, x, n_out=k), _sell(P, x)[:k])


@pytest.mark.parametrize("case", SELL_CASES)
def test_sell_layout(monkeypatch, case):
    """Slices of 32 rows, each row's entries in ascending column order at
    slot j of its lane, padding slots zero and on a column of their row;
    the entries are exactly the matrix's."""
    rng = np.random.default_rng(9)
    A, P = _sell_case(case, rng, monkeypatch)
    S = pell.to_sell(P)
    C = pell.SELL_C
    assert S.n_rows == A.shape[0] and S.n_cols == A.shape[1] and S.nnz == A.nnz
    assert S.vals.dtype == np.float32 and S.cols.dtype == np.int32
    assert S.slice_ptr.dtype == np.int64 and S.n_slices == -(-A.shape[0] // C)
    assert np.all(S.slice_ptr % C == 0)
    B = A.astype(np.float32).tocsr()
    B.sort_indices()
    counts = np.diff(B.indptr)
    for r in range(A.shape[0]):
        s, lane = divmod(r, C)
        slots = np.arange(S.slice_ptr[s] + lane, S.slice_ptr[s + 1], C)
        v, c = S.vals[slots], S.cols[slots]
        k = counts[r]
        np.testing.assert_array_equal(c[:k], B.indices[B.indptr[r]:B.indptr[r + 1]])
        np.testing.assert_array_equal(v[:k], B.data[B.indptr[r]:B.indptr[r + 1]])
        assert np.all(np.diff(c[:k]) > 0)
        assert np.all(v[k:] == 0)
        assert np.all(c[k:] == (c[k - 1] if k else 0))
    # the slice widths are the longest row of each slice
    cpad = np.zeros(S.n_slices * C, np.int64)
    cpad[:A.shape[0]] = counts
    np.testing.assert_array_equal(np.diff(S.slice_ptr) // C,
                                  cpad.reshape(-1, C).max(axis=1))


def test_apply_dispatches_on_operator_type():
    rng = np.random.default_rng(4)
    A = _rand_csr(rng, 4000, 4000, 20000)
    x = rng.standard_normal(4000)
    ref = A @ x
    for op in (pell.build_paged(A, np.float64), ell.build_ell(A, np.float64),
               ell.build_sliced(A, np.float64)):
        y = pell.apply(ell.device_put_tree(op, "cpu"), torch.as_tensor(x)).numpy()
        np.testing.assert_allclose(y, ref, rtol=0, atol=1e-12 * np.abs(ref).max())
    # a PagedMat is the host form: only its upload is applied
    with pytest.raises(TypeError, match="device_put_tree"):
        pell.apply(_tensors(pell.build_paged(A, np.float64)),
                   torch.as_tensor(x))


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
    S = ell.device_put_tree(pell.build_paged(A, np.float32), "cpu")
    before = pell.KERNEL_LAUNCHES
    with pytest.raises(ValueError, match="CUDA tensor"):
        pell.sell_matvec_cuda(S, torch.zeros(100))
    assert pell.KERNEL_LAUNCHES == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    from shm3d_torch._device import resolve_device

    return resolve_device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", SELL_CASES)
def test_cuda_kernel_matches_plain(cuda_device, monkeypatch, case):
    """Sliced-ELL kernel vs its plain version on the card, float32, within
    1e-5 x max|y| (float32 sums, fused in the kernel); one launch a matvec."""
    rng = np.random.default_rng(7)
    A, P = _sell_case(case, rng, monkeypatch)
    Sd = ell.device_put_tree(P, cuda_device)
    x = torch.as_tensor(rng.standard_normal(A.shape[1]), dtype=torch.float32,
                        device=cuda_device)
    before = pell.KERNEL_LAUNCHES
    got = pell.apply(Sd, x)
    assert pell.KERNEL_LAUNCHES == before + 1
    ref = pell.sell_matvec_torch(Sd, x)
    torch.cuda.synchronize()
    assert got.shape == ref.shape == (A.shape[0],)
    err = (got - ref).abs().max().item()
    assert err <= 1e-5 * max(ref.abs().max().item(), 1e-30), err
