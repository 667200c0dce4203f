"""Null-space projection for the trilinear pinning constraints (port of
shm3d.solve.projection).

The constrained Poisson solve runs CG on P H P u = P b with
P = I - A^T (A A^T)^{-1} A, where A is one trilinear row per pinned grid
cell, held as (nodes8 (m, 8) int64, coeffs8 (m, 8)).  P is applied through a
whitened factor of the rows, built in one of two tiers:

- ``bmat`` (m <= ORTHO_GRAM_CAP): the rows re-orthonormalized on the host in
  float64 and stored densely on the touched nodes; P = I - B^T B, exact to
  float32 rounding whatever the conditioning of A A^T.
- ``tmat`` (ORTHO_GRAM_CAP < m <= TFORM_FULL_CAP, float32): the full-row
  factor T = chol(D^-1/2 G D^-1/2 + eps I)^-1 D^-1/2 built on the device,
  applied in factored form with one Gram-refinement step.

Both caps are read from this module at call time, so tests can patch them.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

# copied from shm3d/solve/projection.py (ORTHO_GRAM_CAP, TFORM_FULL_CAP,
# TFORM_FULL_EPS): the same size picks the same tier in both packages
ORTHO_GRAM_CAP = 8192
TFORM_FULL_CAP = 24576
TFORM_FULL_EPS = 3e-6

# Shifts tried by the full-row factorization: eps, 10 eps, 100 eps, 1000 eps.
TFORM_EPS_ATTEMPTS = 4


def a_apply(u: torch.Tensor, nodes8: torch.Tensor, coeffs8: torch.Tensor) -> torch.Tensor:
    """A u: (N,) -> (m,) trilinear evaluation at the pinned points."""
    return (u[nodes8] * coeffs8).sum(dim=1)


class AtTable(NamedTuple):
    """A^T as a gather: each touched node's <= W (row, coefficient) pairs,
    rows ascending, padded with row 0 and coefficient 0."""

    nodes: torch.Tensor   # (K,) int64 touched nodes, unique
    rows: torch.Tensor    # (K, W) int64 constraint rows
    coef: torch.Tensor    # (K, W) coefficients


# copied from shm3d/solve/projection.py (build_at_table), without the
# hi/lo split of the coefficients: the card has native float64
def build_at_table(nodes8: np.ndarray, coeffs8: np.ndarray):
    """Transposed constraint table on the host: (at_nodes (K,), at_rows
    (K, W), at_coef (K, W) float64), K the touched nodes.  The rows are
    deduplicated cells, so a node appears in at most its 8 cells' rows
    (W <= 8)."""
    m, w8 = nodes8.shape
    flat_nodes = np.asarray(nodes8, np.int64).reshape(-1)
    flat_rows = np.repeat(np.arange(m, dtype=np.int64), w8)
    flat_c = np.asarray(coeffs8, np.float64).reshape(-1)
    order = np.argsort(flat_nodes, kind="stable")
    sn, sr, sc = flat_nodes[order], flat_rows[order], flat_c[order]
    at_nodes, starts = np.unique(sn, return_index=True)
    counts = np.diff(np.append(starts, sn.size))
    K, W = at_nodes.size, int(counts.max())
    slot = np.searchsorted(at_nodes, sn)
    pos = np.arange(sn.size) - starts[slot]
    at_rows = np.zeros((K, W), np.int64)
    at_c = np.zeros((K, W), np.float64)
    at_rows[slot, pos] = sr
    at_c[slot, pos] = sc
    return at_nodes, at_rows, at_c


def at_table(nodes8: np.ndarray, coeffs8: np.ndarray, device,
             dtype: torch.dtype) -> AtTable:
    """The transposed constraint table on ``device``, coefficients in
    ``dtype``."""
    at_nodes, at_rows, at_c = build_at_table(nodes8, coeffs8)
    return AtTable(torch.as_tensor(at_nodes, device=device),
                   torch.as_tensor(at_rows, device=device),
                   torch.as_tensor(at_c, device=device).to(dtype))


def at_apply(y: torch.Tensor, at: AtTable, n: int) -> torch.Tensor:
    """A^T y: (m,) -> (N,), a gather over the transposed table written to
    the touched nodes once each.  No two threads add into one address, so
    the sums have one order on every device and in every run (a
    scatter-add through CUDA atomics does not)."""
    out = torch.zeros(n, dtype=y.dtype, device=y.device)
    return out.index_copy_(0, at.nodes, (at.coef * y[at.rows]).sum(dim=1))


class GramTable(NamedTuple):
    """Device artifacts of the Gram matrix G = A A^T: its padded (m, K)
    neighbour table and the whitening factor of one tier."""

    idx: torch.Tensor                      # (m, K) int64 column indices, padded 0
    val: torch.Tensor                      # (m, K) values, padded 0.0
    diag: torch.Tensor                     # (m,) diagonal
    bmat: Optional[torch.Tensor] = None    # (r, nt) orthonormalized rows
    touched: Optional[torch.Tensor] = None # (nt,) int64 touched node ids
    tmat: Optional[torch.Tensor] = None    # (m, m) full-row whitening factor
    tform_eps: Optional[float] = None      # shift the tmat factor settled on


def gram_apply(y: torch.Tensor, gram: GramTable) -> torch.Tensor:
    """(A A^T) y as an O(m K) gather."""
    return (gram.val * y[gram.idx]).sum(dim=1)


# copied from shm3d/solve/projection.py (build_gram_arrays), with np.dtype in
# place of jnp.dtype
def build_gram_arrays(
    nodes8: np.ndarray, coeffs8: np.ndarray, n: int, dtype,
    ortho_cap: Optional[int] = None,
) -> dict:
    """Host-side extraction of the sparse Gram matrix into a padded neighbor
    table (K = max nonzeros per row, <= 27: the 26 cell neighbors + self),
    plus — below the ortho cap — the orthonormalized row factor (see
    GramTable docstring).  Returns plain numpy arrays (the serializable
    operator-cache artifact; shm3d.utils.diskcache)."""
    import scipy.sparse as sp

    if ortho_cap is None:
        ortho_cap = ORTHO_GRAM_CAP  # resolved at call time (patchable in tests)
    m = nodes8.shape[0]
    rows = np.repeat(np.arange(m), 8)
    A = sp.coo_matrix(
        (coeffs8.reshape(-1), (rows, nodes8.reshape(-1))), shape=(m, n)
    ).tocsr()
    G = (A @ A.T).tocsr()
    G.sum_duplicates()
    nnz = np.diff(G.indptr)
    K = int(nnz.max())
    idx = np.zeros((m, K), dtype=np.int32)
    val = np.zeros((m, K), dtype=np.float64)
    r = np.repeat(np.arange(m), nnz)
    c = np.arange(G.nnz) - np.repeat(G.indptr[:-1], nnz)
    idx[r, c] = G.indices
    val[r, c] = G.data

    d = G.diagonal()
    out = {"idx": idx, "val": val, "diag": d}
    if m <= ortho_cap:
        # exact f64 re-orthonormalization of the row space (P is basis-
        # independent); exact-duplicate rows show up as eigenvalues at the
        # f64 noise floor and are dropped — an exact rank reduction
        dscale = 1.0 / np.sqrt(d)
        touched = np.unique(nodes8)
        remap = np.zeros(n, dtype=np.int64)
        remap[touched] = np.arange(touched.size)
        Asub = sp.coo_matrix(
            (coeffs8.reshape(-1), (rows, remap[nodes8.reshape(-1)])),
            shape=(m, touched.size),
        ).tocsr()
        Gs = (sp.diags(dscale) @ G @ sp.diags(dscale)).toarray()
        lam, Q = np.linalg.eigh(Gs)
        keep = lam > 1e-10 * lam[-1]
        T = (Q[:, keep] / np.sqrt(lam[keep])).T * dscale[None, :]
        # sparse @ dense: O(nnz(A) * r), vs O(m^2 nt) for a dense product
        B = np.ascontiguousarray((Asub.T @ T.T).T)
        # stored in the compute dtype (dtype is part of the cache key)
        out["bmat"] = B.astype(np.dtype(dtype).type)
        out["touched"] = touched.astype(np.int32)
    return out


# copied from shm3d/solve/projection.py (build_tform_full_arrays)
def build_tform_full_arrays(nodes8: np.ndarray, coeffs8: np.ndarray,
                            n: int) -> dict:
    """FULL-row whitening tier (ORTHO_GRAM_CAP < m <= TFORM_FULL_CAP):
    host side only extracts the sparse Gram table; the dense factor is
    built on device at load time (``gram_from_arrays`` -> ``_device_tform``)
    so the persisted artifact stays a few MB instead of m^2 * 4 B."""
    arr = build_gram_arrays(nodes8, coeffs8, n, np.float32,
                            ortho_cap=0)  # sparse table only, no bmat
    arr["tform_eps"] = np.float64(TFORM_FULL_EPS)
    return arr


def _device_tform(idx: torch.Tensor, val: torch.Tensor, diag: torch.Tensor,
                  eps: float) -> Optional[torch.Tensor]:
    """T = chol(D^-1/2 G D^-1/2 + eps I)^-1 D^-1/2 on the tensors' device,
    or None when the Cholesky factorization breaks down (cuSOLVER and LAPACK
    report that through ``info``, not through NaNs).  One triangular solve
    against the full (m, m) right-hand side: about 1 GB in float32 at
    m = 15.8k."""
    m = idx.shape[0]
    dtype = val.dtype
    dscale = torch.rsqrt(torch.clamp_min(diag, torch.finfo(dtype).tiny))
    rows = torch.arange(m, device=idx.device)[:, None].expand_as(idx)
    Gs = torch.zeros((m, m), dtype=dtype, device=val.device)
    Gs.index_put_((rows, idx), val * dscale[:, None] * dscale[idx], accumulate=True)
    Gs.diagonal().add_(eps)
    L, info = torch.linalg.cholesky_ex(Gs)
    del Gs
    if int(info) != 0:
        return None
    T = torch.linalg.solve_triangular(L, torch.diag(dscale), upper=False)
    if not bool(torch.isfinite(T).all()):
        return None
    return T


def gram_from_arrays(arr: dict, device, dtype: torch.dtype) -> GramTable:
    """Device GramTable from (possibly disk-loaded) host arrays.

    For the full-row tier the shift starts at ``arr["tform_eps"]`` and grows
    x10 on each breakdown (TFORM_EPS_ATTEMPTS shifts in all); the shift that
    succeeded is recorded in ``GramTable.tform_eps``.  When every shift
    fails this raises: the host-projected tier it would fall back to is not
    ported yet (ROADMAP A10)."""
    idx = torch.as_tensor(np.asarray(arr["idx"]), device=device).long()
    val = torch.as_tensor(np.asarray(arr["val"]), device=device).to(dtype)
    diag = torch.as_tensor(np.asarray(arr["diag"]), device=device).to(dtype)
    bmat = arr.get("bmat")
    touched = arr.get("touched")
    tmat = arr.get("tmat")
    eps = None
    if tmat is not None:
        tmat = torch.as_tensor(np.asarray(tmat), device=device).to(dtype)
    elif arr.get("tform_eps") is not None:
        eps = float(arr["tform_eps"])
        for _ in range(TFORM_EPS_ATTEMPTS):
            tmat = _device_tform(idx, val, diag, eps)
            if tmat is not None:
                break
            eps *= 10.0
        else:
            raise RuntimeError(
                f"full-row whitening factorization (m={idx.shape[0]}) failed at "
                f"every shift up to {eps / 10.0:g}; the host-projected tier is "
                "not ported yet (ROADMAP A10)")
    return GramTable(
        idx, val, diag,
        None if bmat is None else torch.as_tensor(np.asarray(bmat), device=device).to(dtype),
        None if touched is None else torch.as_tensor(np.asarray(touched), device=device).long(),
        tmat,
        eps,
    )


def make_projector(nodes8: torch.Tensor, coeffs8: torch.Tensor, gram: GramTable,
                   n: int, at: AtTable):
    """P v = v - A^T (A A^T)^{-1} A v through the whitened factor of
    ``gram`` (``tmat`` or ``bmat``); ``at`` is A^T's table for ``tmat``."""
    if gram.tmat is not None:
        T = gram.tmat

        def project_t(v):
            a = a_apply(v, nodes8, coeffs8)
            z = T.T @ (T @ a)
            # one Gram-refinement step: squares the damping error of the
            # eps-shifted factor and mops up its float32 rounding
            r = a - gram_apply(z, gram)
            z = z + T.T @ (T @ r)
            return v - at_apply(z, at, n)

        return project_t

    if gram.bmat is None:
        raise NotImplementedError(
            "GramTable has neither bmat nor tmat: the host-projected tier is "
            "not ported yet (ROADMAP A10)")
    B = gram.bmat

    def project(v):
        w = B @ v[gram.touched]
        return v.index_add(0, gram.touched, -(B.T @ w))

    return project


# copied from shm3d/solve/projection.py (host_gram_factor, host_project):
# the exact float64 projection of the defect correction
def host_gram_factor(nodes8: np.ndarray, coeffs8: np.ndarray, n: int):
    """(A, splu(A A^T)) on the host: the sparse rows and the LU factor of
    their sparse Gram matrix, with a 1e-14 shift for exact-duplicate rows."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    m = nodes8.shape[0]
    rows = np.repeat(np.arange(m), 8)
    A = sp.coo_matrix(
        (coeffs8.reshape(-1), (rows, nodes8.reshape(-1))), shape=(m, n)
    ).tocsr()
    gram = (A @ A.T).tocsc()
    gram = gram + 1e-14 * sp.eye(m, format="csc")
    return A, spla.splu(gram)


def host_project(v: np.ndarray, A, gram_lu) -> np.ndarray:
    """Exact float64 P v with the host factorization."""
    return v - A.T @ gram_lu.solve(A @ v)
