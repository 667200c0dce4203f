"""Smoothed-aggregation algebraic multigrid for unstructured FEM operators
(port of shm3d.solve.amg).

The hierarchy is built on the host with SciPy in f64, as in the JAX package
(the setup below is its code, copied): strength-based aggregation seeded
with ``default_rng(0)``, smoothed and truncated prolongators, filtered
Galerkin coarse operators, a dense (pseudo)inverse on the coarsest level.
It comes back as numpy leaves in their final dtypes; level operators at or
above ``paged_min_nnz`` are stored paged (solve/pell.py; uploaded as its
sliced ELL) and width-skewed transfer operators sliced (solve/ell.py).

On the device the preconditioner is a symmetric V-cycle with degree-3
Chebyshev smoothing over each level's baked [rho/30, 1.1 rho] interval of
D^-1 A; every operator application goes through ``pell.apply``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np

from ..utils import order

from ..utils import tree as tree_mod
from . import ell, pell

#: transfer operators at/above this nnz with ELL padding waste > 1.5x build
#: as ell.SlicedEll on the paged path
SLICED_MIN_NNZ = 200_000

#: Chebyshev smoother degree and interval (the JAX package's measured
#: choice; its SHM3D_CHEB_DEGREE experiment knob is not ported)
CHEB_DEGREE = 3
CHEB_LO_FRAC = 30.0
CHEB_LMAX_SAFETY = 1.1


@tree_mod.register
class AMGLevel(NamedTuple):
    A: Optional[ell.EllMat]  # operator A_l; None at level 0 when the solve's
                             # own matvec is reused (skip_level0_A)
    inv_diag: np.ndarray     # 1 / diag(A_l), the Chebyshev smoother's scaling
    P: ell.EllMat            # prolongation (n_l x n_c)
    PT: ell.EllMat           # restriction P^T (n_c x n_l)
    cheb: np.ndarray         # (2,) [theta, delta]: Chebyshev interval
                             # midpoint / half-width over the D^-1 A spectrum


@tree_mod.register
class AMGHierarchy(NamedTuple):
    levels: Tuple[AMGLevel, ...]
    coarse_inv: np.ndarray      # dense (pseudo)inverse of the coarsest A
    sizes: Tuple[int, ...]      # per-level sizes (incl. coarsest)
    l0_nnz: int = 0             # level-0 operator nnz


def _aggregate(A, theta: float) -> np.ndarray:
    """Strength-based aggregation; returns (n,) aggregate ids, with -1
    marking dropped nodes (rows with no strong couplings).  Parallel
    MIS-style rounds with random priorities from ``default_rng(0)``, then
    leftovers attach to an adjacent aggregate."""
    import scipy.sparse as sp

    n = A.shape[0]
    d = np.abs(A.diagonal())
    d = np.where(d > 0, d, 1.0)
    C = A.tocoo()
    strong_mask = (
        (C.row != C.col)
        & (np.abs(C.data) >= theta * np.sqrt(d[C.row] * d[C.col]))
    )
    rows = C.row[strong_mask]
    cols = C.col[strong_mask]
    S = sp.csr_matrix((np.ones(rows.shape[0], np.int8), (rows, cols)), shape=(n, n))
    indptr, indices = S.indptr, S.indices
    deg = np.diff(indptr)
    isolated = deg == 0

    rng = np.random.default_rng(0)
    pri = rng.permutation(n).astype(np.int64)  # unique priorities
    agg = np.full(n, -1, dtype=np.int64)
    next_id = 0
    MAX = np.iinfo(np.int64).max
    if indices.size == 0:
        return agg
    red_idx = np.minimum(indptr[:-1], indices.size - 1)

    def row_min(values_per_edge):
        """Per-row min over the strong neighbors (MAX for empty rows)."""
        out = np.minimum.reduceat(values_per_edge, red_idx)
        return np.where(isolated, MAX, out)

    for _ in range(4):  # MIS rounds
        free = (agg < 0) & ~isolated
        if not free.any():
            break
        nbr_pri = np.where(free[indices], pri[indices], MAX)
        blocked = row_min(np.where(agg[indices] >= 0, np.int64(0), MAX))
        min_free_nbr = row_min(nbr_pri)
        seeds = free & (pri < min_free_nbr) & (blocked > 0)
        ns = int(seeds.sum())
        if ns == 0:
            break
        agg[seeds] = next_id + np.arange(ns)
        seed_of_pri = np.full(n, -1, dtype=np.int64)
        seed_of_pri[pri[seeds]] = agg[seeds]
        next_id += ns
        is_seed_nbr = seeds[indices]
        cand = np.where(is_seed_nbr, pri[indices], MAX)
        best = row_min(cand)
        grab = (agg < 0) & ~isolated & (best < MAX)
        agg[grab] = seed_of_pri[best[grab]]

    for _ in range(3):  # leftovers drain into adjacent aggregates
        free = (agg < 0) & ~isolated
        if not free.any():
            break
        nbr_agg = np.where(agg[indices] >= 0, agg[indices], MAX)
        best = row_min(nbr_agg)
        hit = free & (best < MAX)
        agg[hit] = best[hit]
    free = (agg < 0) & ~isolated
    nf = int(free.sum())
    if nf:
        agg[free] = next_id + np.arange(nf)
    return agg


def _rho_dinv_a(A, d, iters: int = 12) -> float:
    """Power-iteration estimate of rho(D^{-1} A)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=A.shape[0])
    x /= np.linalg.norm(x)
    rho = 2.0
    for _ in range(iters):
        y = (A @ x) / d
        nrm = np.linalg.norm(y)
        if nrm == 0:
            break
        rho = nrm
        x = y / nrm
    return float(rho)


def _truncate_prolongator(P, k: int):
    """Keep the k largest-|.| entries per row of CSR ``P``, rescaled so row
    sums are preserved."""
    import scipy.sparse as sp

    counts = np.diff(P.indptr)
    if counts.size == 0 or counts.max() <= k:
        return P
    n = P.shape[0]
    w = int(counts.max())
    rows_all = np.repeat(np.arange(n, dtype=np.int64), counts)
    pos = np.arange(P.indices.size, dtype=np.int64) - np.repeat(P.indptr[:-1], counts)
    vals_p = np.zeros((n, w))
    cols_p = np.zeros((n, w), np.int64)
    vals_p[rows_all, pos] = P.data
    cols_p[rows_all, pos] = P.indices
    top = np.argpartition(-np.abs(vals_p), k - 1, axis=1)[:, :k]
    kv = np.take_along_axis(vals_p, top, axis=1)
    kc = np.take_along_axis(cols_p, top, axis=1)
    orig_sum = vals_p.sum(axis=1)
    kept_sum = kv.sum(axis=1)
    scale = np.where(np.abs(kept_sum) > 0.1 * np.abs(orig_sum) + 1e-300,
                     orig_sum / np.where(kept_sum == 0, 1.0, kept_sum), 1.0)
    kv = kv * scale[:, None]
    keep = kv != 0.0
    r = np.repeat(np.arange(n, dtype=np.int64), k)
    out = sp.csr_matrix((kv.ravel()[keep.ravel()],
                         (r[keep.ravel()], kc.ravel()[keep.ravel()])),
                        shape=P.shape)
    out.sum_duplicates()
    return out


def _filter_operator(A, drop_tol: float):
    """Drop off-diagonal entries |a_ij| < drop_tol sqrt(a_ii a_jj), adding
    |a_ij| to the row's diagonal (keeps the filtered operator SPD)."""
    import scipy.sparse as sp

    if drop_tol <= 0.0:
        return A
    C = A.tocoo()
    d = np.abs(A.diagonal())
    d = np.where(d > 0, d, 1.0)
    is_diag = C.row == C.col
    keep = is_diag | (np.abs(C.data) >= drop_tol * np.sqrt(d[C.row] * d[C.col]))
    dropped = ~keep
    comp = np.bincount(C.row[dropped], weights=np.abs(C.data[dropped]),
                       minlength=A.shape[0])
    out = sp.csr_matrix((C.data[keep], (C.row[keep], C.col[keep])), shape=A.shape)
    out = (out + sp.diags(comp.astype(out.dtype))).tocsr()
    out.sum_duplicates()
    return out


def build_hierarchy_host(
    H, dtype, theta: float = 0.08, max_coarse: int = 192, max_levels: int = 12,
    p_keep: int = 4, drop_tol: float = 0.02, pad_rows_to: int = 1,
    first_P=None, skip_level0_A: bool = False,
    paged_min_nnz: Optional[int] = None,
) -> AMGHierarchy:
    """Host-side SA-AMG setup for SPD (or semi-definite) sparse ``H``;
    returns numpy leaves (ship with :func:`hierarchy_to_device`).

    ``first_P``: explicit level-0 prolongator (the CR face solves coarsen
    faces -> vertices geometrically).  ``skip_level0_A``: store None for
    level 0's operator; the caller passes its own solve matvec to
    :func:`make_preconditioner_parts`.  ``paged_min_nnz``: store level
    operators at or above this nnz paged (float32 only) and renumber each
    coarse space by first fine member, so the caller's locality order
    carries down the hierarchy."""
    import scipy.sparse as sp

    np_dtype = np.dtype(dtype)

    def build_op(M, square: bool):
        M = M.tocsr()
        if (square and paged_min_nnz is not None
                and M.nnz >= paged_min_nnz and np_dtype == np.float32):
            return pell.build_paged(M, np_dtype)
        if (not square and paged_min_nnz is not None and pad == 1
                and M.nnz >= SLICED_MIN_NNZ and ell.sliced_waste(M) > 1.5):
            return ell.build_sliced(M, np_dtype)
        return ell.build_ell(M, np_dtype, pad_rows_to=pad)

    A = H.tocsr().astype(np.float64)
    l0_nnz = int(A.nnz)
    levels = []
    sizes = [A.shape[0]]
    pad = pad_rows_to
    while A.shape[0] > max_coarse and len(levels) < max_levels:
        n = A.shape[0]
        d = np.asarray(A.diagonal())
        d = np.where(np.abs(d) > 0, d, 1.0)
        rho = _rho_dinv_a(A, d)
        omega = 4.0 / (3.0 * rho)
        if len(levels) == 0 and first_P is not None:
            P = first_P.tocsr()
        else:
            agg = _aggregate(A, theta)
            nc = int(agg.max()) + 1
            if nc >= n or nc == 0:  # aggregation stalled
                break
            kept = agg >= 0
            T = sp.csr_matrix(
                (np.ones(int(kept.sum())), (np.flatnonzero(kept), agg[kept])),
                shape=(n, nc),
            )
            P = (T - sp.diags(omega / d) @ (A @ T)).tocsr()
            P = _truncate_prolongator(P, p_keep)
        if paged_min_nnz is not None:
            perm_c = order.first_row_order(P)
            P = P[:, perm_c].tocsr()
        Ac = _filter_operator((P.T @ A @ P).tocsr(), drop_tol)
        Ac.sum_duplicates()

        A_panel = (None if (skip_level0_A and len(levels) == 0)
                   else build_op(A, square=True))
        lmax = CHEB_LMAX_SAFETY * rho
        lmin = rho / CHEB_LO_FRAC
        levels.append(AMGLevel(
            A_panel,
            (1.0 / d).astype(np_dtype),
            build_op(P, square=False),
            build_op(P.T, square=False),
            np.array([(lmax + lmin) / 2.0, (lmax - lmin) / 2.0], np_dtype),
        ))
        A = Ac
        sizes.append(A.shape[0])

    if A.shape[0] > 8 * max_coarse:
        # coarsening failed to reach dense-solve size: a diagonal coarse
        # "solve" keeps the preconditioner SPD and cheap
        d = np.asarray(A.diagonal())
        d = np.where(np.abs(d) > 0, d, 1.0)
        coarse_inv = np.diag(1.0 / d).astype(np_dtype)
    else:
        coarse_inv = np.linalg.pinv(A.toarray(), rcond=1e-10).astype(np_dtype)
    return AMGHierarchy(tuple(levels), coarse_inv, tuple(sizes), l0_nnz)


def hierarchy_to_device(h: AMGHierarchy, device, mesh=None) -> AMGHierarchy:
    """The hierarchy with its arrays on ``device``.  With a device ``mesh``
    (``device`` its first device) every level operator stored paged (the
    sliced-ELL encoding) is split by rows over it where it gives every
    shard a 32-row slice (``ell.device_put_tree``); the transfers, the
    other levels, the smoother's vectors and ``coarse_inv`` stay on the
    first device (``parallel.rows.first_whole_level`` says where the split
    ends)."""
    levels, coarse_inv = ell.device_put_tree((h.levels, h.coarse_inv), device, mesh)
    return AMGHierarchy(levels, coarse_inv, tuple(h.sizes), h.l0_nnz)


def make_preconditioner_parts(levels, coarse_inv, sizes,
                              matvec0: Optional[Callable] = None):
    """V-cycle preconditioner M ~ H^{-1} with degree-CHEB_DEGREE Chebyshev
    smoothing on the D^{-1} A interval baked into each level: identical pre
    (from zero) and post polynomials.  ``sizes``: the true per-level
    lengths.  ``matvec0``: the level-0 operator application when the
    hierarchy was built with skip_level0_A (the same operator the hierarchy
    was built on).

    The Chebyshev coefficients are read to the host once, here, so the
    cycle's scalar recurrences cost no device launches."""
    degree = CHEB_DEGREE
    intervals = [tuple(float(v) for v in lvl.cheb.tolist()) for lvl in levels]

    def mv(level: int, lvl: AMGLevel, x):
        if lvl.A is None:
            assert level == 0 and matvec0 is not None, "missing level-0 matvec"
            return matvec0(x)
        return pell.apply(lvl.A, x, n_out=sizes[level])

    def cheb(level: int, lvl: AMGLevel, b, x0=None):
        """Chebyshev(degree) iteration on D^{-1} A x = D^{-1} b over the
        baked [lmin, lmax]; the from-zero form skips the first matvec."""
        theta, delta = intervals[level]
        sigma = theta / delta
        rho_c = 1.0 / sigma
        if x0 is None:
            d = (lvl.inv_diag * b) / theta
            x = d
        else:
            x = x0
            d = (lvl.inv_diag * (b - mv(level, lvl, x))) / theta
            x = x + d
        for _ in range(degree - 1):
            r = lvl.inv_diag * (b - mv(level, lvl, x))
            rho_new = 1.0 / (2.0 * sigma - rho_c)
            d = rho_new * rho_c * d + (2.0 * rho_new / delta) * r
            rho_c = rho_new
            x = x + d
        return x

    def cycle(level: int, b):
        if level == len(levels):
            return coarse_inv @ b
        lvl = levels[level]
        x = cheb(level, lvl, b)  # pre-smooth from zero
        r = b - mv(level, lvl, x)
        rc = pell.apply(lvl.PT, r, n_out=sizes[level + 1])
        xc = cycle(level + 1, rc)
        x = x + pell.apply(lvl.P, xc, n_out=sizes[level])
        return cheb(level, lvl, b, x0=x)

    return lambda b: cycle(0, b)


def make_preconditioner(h: AMGHierarchy, matvec0: Optional[Callable] = None):
    return make_preconditioner_parts(h.levels, h.coarse_inv, h.sizes,
                                     matvec0=matvec0)


def masked_operator(H, mask: np.ndarray):
    """Dirichlet elimination: diag(mask) H diag(mask) + diag(1 - mask), the
    operator the ZeroSet solves apply (identity rows on constrained
    unknowns)."""
    import scipy.sparse as sp

    Dm = sp.diags(mask.astype(np.float64))
    return (Dm @ H @ Dm + sp.diags(1.0 - mask.astype(np.float64))).tocsr()
