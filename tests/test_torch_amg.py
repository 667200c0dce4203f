"""Port AMG and ELL operators (shm3d_torch.solve.{amg,ell}) against
shm3d.solve.{amg,ell}, on the Crouzeix-Raviart operator of the conforming
cube fixture (tests/test_cr.py).

The host hierarchy is the JAX package's code, copied: the same sizes and
leaves equal within 1e-12 (paged level operators compared as the matrices
they encode, since the port stores no compile-shape padding passes).  The
V-cycle and the matvecs are compared in f64 within 1e-12 relative: the
same arithmetic summed in another order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shm3d.solve import amg as jamg
from shm3d.solve import ell as jell
from shm3d.tet import fem
from shm3d.tet.cr_solver import _first_P_from_cols
from shm3d_torch.solve import amg, ell, pell
from shm3d_torch.utils import tree
from test_cr import _conforming_fixture

torch.set_num_threads(2)

RTOL = 1e-12


@pytest.fixture(scope="module")
def cr_system():
    """(masked CR operator, face->vertex first prolongator) of the cube."""
    tm, _, surf_ids, _ = _conforming_fixture()
    L = fem.build_cr_operators(tm).L_scipy().tocsr()
    mask = np.ones(tm.n_faces)
    mask[surf_ids] = 0.0
    H = amg.masked_operator(L, mask)
    np.testing.assert_array_equal(H.toarray(), jamg.masked_operator(L, mask).toarray())
    return L, H, _first_P_from_cols(np.asarray(tm.faces), tm.n_vertices)


def assert_tree_close(a, b, path="h"):
    """Port tree ``a`` against JAX tree ``b``, field by field."""
    if isinstance(a, pell.PagedMat):
        A, B = pell.to_scipy(a), pell.to_scipy(tree.adopt(b))
        assert a.nnz == b.nnz and A.shape == B.shape, path
        assert abs(A - B).max() <= RTOL * abs(B).max(), path
    elif a is None:
        assert b is None, path
    elif hasattr(a, "_fields"):
        assert type(a).__name__ == type(b).__name__, path
        for f in a._fields:
            assert_tree_close(getattr(a, f), getattr(b, f), f"{path}.{f}")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), path
        for k, (u, v) in enumerate(zip(a, b)):
            assert_tree_close(u, v, f"{path}[{k}]")
    elif isinstance(a, np.ndarray):
        b = np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, path
        scale = np.abs(b).max() if b.size and b.dtype.kind == "f" else 0
        np.testing.assert_allclose(a, b, rtol=0, atol=RTOL * scale, err_msg=path)
    else:
        assert a == b, path


@pytest.mark.parametrize("dtype,paged_min_nnz", [
    (np.float64, None),
    (np.float32, 1),   # every level operator paged, coarse spaces renumbered
])
def test_host_hierarchy_matches_jax(cr_system, dtype, paged_min_nnz):
    _, H, first_P = cr_system
    kw = dict(skip_level0_A=True, first_P=first_P, paged_min_nnz=paged_min_nnz)
    h = amg.build_hierarchy_host(H, dtype, **kw)
    hj = jamg.build_hierarchy_host(H, dtype, **kw)
    assert h.sizes == hj.sizes and len(h.sizes) >= 3
    assert_tree_close(h, hj)
    if paged_min_nnz:
        assert isinstance(h.levels[1].A, pell.PagedMat)


def test_aggregation_is_deterministic(cr_system):
    L, _, _ = cr_system
    np.testing.assert_array_equal(amg._aggregate(L, 0.08), jamg._aggregate(L, 0.08))


def _jax_vcycle(hj, H, r):
    hd = jamg.hierarchy_to_device(hj)
    A0 = jell.device_put_tree(jell.build_ell(H, r.dtype))
    M = jamg.make_preconditioner_parts(hd.levels, hd.coarse_inv, hd.sizes, degree=3,
                                       matvec0=lambda v: jell.matvec(A0, v))
    return np.asarray(M(jnp.asarray(r)))


def test_vcycle_matches_jax_f64(cr_system):
    _, H, first_P = cr_system
    kw = dict(skip_level0_A=True, first_P=first_P)
    h = amg.build_hierarchy_host(H, np.float64, **kw)
    r = np.random.default_rng(0).standard_normal(H.shape[0])
    ref = _jax_vcycle(jamg.build_hierarchy_host(H, np.float64, **kw), H, r)
    hd = amg.hierarchy_to_device(h, "cpu")
    A0 = ell.device_put_tree(ell.build_ell(H, np.float64), "cpu")
    M = amg.make_preconditioner_parts(hd.levels, hd.coarse_inv, hd.sizes,
                                      matvec0=lambda v: ell.matvec(A0, v))
    got = M(torch.as_tensor(r)).numpy()
    assert np.linalg.norm(got - ref) <= RTOL * np.linalg.norm(ref)


def test_vcycle_paged_levels_f32(cr_system):
    """Mixed encodings (paged level operators, ELL transfers) in float32:
    the V-cycle agrees with JAX's to float32 rounding."""
    _, H, first_P = cr_system
    kw = dict(skip_level0_A=True, first_P=first_P, paged_min_nnz=1)
    h = amg.build_hierarchy_host(H, np.float32, **kw)
    hj = jamg.build_hierarchy_host(H, np.float32, **kw)
    r = np.random.default_rng(1).standard_normal(H.shape[0]).astype(np.float32)
    ref = _jax_vcycle(hj, H, r)
    ht = amg.hierarchy_to_device(h, "cpu")
    A0 = ell.device_put_tree(ell.build_ell(H, np.float32), "cpu")
    got = amg.make_preconditioner(ht, matvec0=lambda v: ell.matvec(A0, v))(
        torch.as_tensor(r)).numpy()
    assert np.linalg.norm(got - ref) <= 1e-5 * np.linalg.norm(ref)


@pytest.mark.parametrize("encoding", ["ell", "ell_tail", "sliced"])
def test_matvecs_match_jax(cr_system, encoding):
    L, _, first_P = cr_system
    # the restriction P^T has long-tailed row widths (the sliced case)
    M = first_P.T.tocsr() if encoding == "sliced" else L
    build = {"ell": lambda m, b: b.build_ell(m, np.float64),
             "ell_tail": lambda m, b: b.build_ell(m, np.float64, width=3),
             "sliced": lambda m, b: b.build_sliced(m, np.float64, max_slices=4)}[encoding]
    op, opj = build(M, ell), build(M, jell)
    assert_tree_close(op, opj)
    x = np.random.default_rng(2).standard_normal(M.shape[1])
    dev_op = ell.device_put_tree(op, "cpu")
    if encoding == "ell_tail":
        # the device form carries the tail inside its panel
        assert op.tail_rows.shape[0] > 0 and dev_op.tail_rows.shape[0] == 0
        with pytest.raises(ValueError, match="tail"):
            ell.matvec(op._replace(**{k: torch.as_tensor(v) for k, v in op._asdict().items()}),
                       torch.as_tensor(x))
    got = pell.apply(dev_op, torch.as_tensor(x), n_out=M.shape[0]).numpy()
    fj = jell.sliced_matvec if encoding == "sliced" else jell.matvec
    ref = np.asarray(fj(jell.device_put_tree(opj), jnp.asarray(x), n_out=M.shape[0]))
    np.testing.assert_allclose(got, ref, rtol=0, atol=RTOL * np.abs(ref).max())
    np.testing.assert_allclose(got, M @ x, rtol=0, atol=RTOL * np.abs(ref).max())


@pytest.mark.parametrize("encoding", ["ell", "ell_tail", "ell_padded", "sliced",
                                      "sliced_empty_rows"])
def test_host_encodings_back_to_scipy(cr_system, encoding):
    """ell.to_scipy returns the matrix an EllMat / SlicedEll was built from,
    entry for entry, and the sliced-ELL form of that is the form of the
    matrix itself (what the float32 vertex operator's upload relies on)."""
    L, _, first_P = cr_system
    M = L.tocsr().astype(np.float32)
    if encoding.startswith("sliced"):
        M = first_P.T.tocsr().astype(np.float32)
    if encoding == "sliced_empty_rows":
        M = M.tolil()
        M[1, :] = 0
        M[M.shape[0] - 1, :] = 0
        M = M.tocsr()
    M.eliminate_zeros()
    M.sort_indices()
    op = {"ell": lambda: ell.build_ell(M, np.float32),
          "ell_tail": lambda: ell.build_ell(M, np.float32, width=3),
          "ell_padded": lambda: ell.build_ell(M, np.float32, pad_rows_to=128),
          "sliced": lambda: ell.build_sliced(M, np.float32, max_slices=4),
          "sliced_empty_rows": lambda: ell.build_sliced(M, np.float32, max_slices=4),
          }[encoding]()
    back = ell.to_scipy(op, M.shape)
    assert back.dtype == np.float32 and back.shape == M.shape
    np.testing.assert_array_equal(back.indptr, M.indptr)
    np.testing.assert_array_equal(back.indices, M.indices)
    np.testing.assert_array_equal(back.data, M.data)
    a, b = pell.sell_from_csr(back, np.float32), pell.sell_from_csr(M, np.float32)
    for leaf in ("vals", "cols", "slice_ptr"):
        np.testing.assert_array_equal(getattr(a, leaf), getattr(b, leaf))


def test_hierarchy_device_put_keeps_dtypes(cr_system):
    _, H, first_P = cr_system
    h = amg.build_hierarchy_host(H, np.float32, skip_level0_A=True,
                                 first_P=first_P, paged_min_nnz=1)
    hd = amg.hierarchy_to_device(h, "cpu")
    lvl = hd.levels[1]
    # a paged level operator goes to the device as sliced ELL
    assert isinstance(h.levels[1].A, pell.PagedMat) and isinstance(lvl.A, pell.SellMat)
    assert lvl.A.vals.dtype == torch.float32
    assert lvl.A.cols.dtype == torch.int32
    assert lvl.A.slice_ptr.dtype == torch.int64
    assert lvl.P.cols.dtype == torch.int32 and hd.coarse_inv.dtype == torch.float32
    assert hd.sizes == h.sizes
