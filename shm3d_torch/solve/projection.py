"""Null-space projection for the trilinear pinning constraints (port of
shm3d.solve.projection).

The constrained Poisson solve runs CG on P H P u = P b with
P = I - A^T (A A^T)^{-1} A, where A is one trilinear row per pinned grid
cell, held as (nodes8 (m, 8) int64, coeffs8 (m, 8)).  P is applied through a
whitened factor of the rows, built in one of three tiers:

- ``bmat`` (m <= ORTHO_GRAM_CAP): the rows re-orthonormalized on the host in
  float64 and stored densely on the touched nodes; P = I - B^T B, exact to
  float32 rounding whatever the conditioning of A A^T.
- ``tmat`` of all rows (ORTHO_GRAM_CAP < m <= TFORM_FULL_CAP, float32): the
  full-row factor T = chol(D^-1/2 G D^-1/2 + eps I)^-1 D^-1/2 built on the
  device, applied in factored form with one Gram-refinement step.
- ``tmat`` of a subsample (m > TFORM_FULL_CAP, float32): the exact host
  factor of spatially separated pin rows (``build_tform_arrays``).

A factor built by Cholesky is lower triangular and is kept as packed tiles
of its lower triangle (``TriFactor``), half the square's bytes.  Its
products ``tri_gemv`` (T v, and T^T w with ``trans``) are one launch each
of the kernel ``csrc/tri_gemv.cu`` on CUDA tensors (``TRI_GEMV_LAUNCHES``
counts them) and the plain version ``tri_gemv_torch`` on the CPU.  The
eigendecomposition fallback of ``build_tform_arrays`` gives a dense (r, m)
factor, applied with plain matrix products.

Past ORTHO_GRAM_CAP in float64, or without subsampled pins, the table has
neither factor and the solver projects each iterate through the host splu
factor of the full Gram matrix (``host_gram_factor``).

Both caps are read from this module at call time, so tests can patch them.

On a device mesh the node vectors are z-slabs (``Shards``) and the rows'
tables are ``NodeGather`` (where each row's nodes live) and ``SlabAt`` (A^T's
table cut per slab).  A u gathers the values of each row's 8 nodes from
their slabs onto the first device and sums them there in the single-device
order; A^T y gives each slab its own nodes from the (m,) vector, broadcast
to its device.  The (m,) vectors, the factors and the host splu stay on the
first device.  So both are bitwise equal to their single-device forms.
"""

from __future__ import annotations

import ctypes
import warnings
from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from ..parallel.shards import Shards, broadcast
from . import graphs

# copied from shm3d/solve/projection.py (ORTHO_GRAM_CAP, TFORM_FULL_CAP,
# TFORM_FULL_EPS): the same size picks the same tier in both packages
ORTHO_GRAM_CAP = 8192
TFORM_FULL_CAP = 24576
TFORM_FULL_EPS = 3e-6

# Shifts tried by the full-row factorization: eps, 10 eps, 100 eps, 1000 eps.
TFORM_EPS_ATTEMPTS = 4

# Products with the whitening factor T or T^T in this process, 4 a
# ``project_t`` (counted at each run of a CUDA graph that holds one).
TMAT_PRODUCTS = 0

# Launches of the packed-triangle kernel (``tri_gemv_cuda``), counted as
# TMAT_PRODUCTS is: on a solve whose factor is a ``TriFactor`` on the card
# the two counts move together.
TRI_GEMV_LAUNCHES = 0

# the side of a packed tile (csrc/tri_gemv.cu: TILE)
TRI_TILE = 64


class NodeGather:
    """Where the entries of an (m, w) node table live on a mesh of z-slabs
    of ``slab_len`` nodes: per shard the entries' flat positions (on the
    first device) and their slab-local node ids (on the shard's device)."""

    def __init__(self, nodes, mesh, slab_len: int):
        nodes = np.asarray(nodes.cpu() if isinstance(nodes, torch.Tensor) else nodes,
                           np.int64)
        self.shape = nodes.shape
        self.mesh = mesh
        flat = nodes.reshape(-1)
        owner = flat // slab_len
        self.pos, self.loc = [], []
        for k, dev in enumerate(mesh.devices):
            pos = np.nonzero(owner == k)[0]
            self.pos.append(torch.as_tensor(pos, device=mesh.first))
            self.loc.append(torch.as_tensor(flat[pos] - k * slab_len, device=dev))

    def values(self, u: Shards) -> torch.Tensor:
        """u at the table's nodes, (m, w) on the first device."""
        out = torch.empty(int(np.prod(self.shape)), dtype=u.dtype, device=self.mesh.first)
        for part, pos, loc in zip(u.parts, self.pos, self.loc):
            out.index_copy_(0, pos, part[loc].to(out.device))
        return out.reshape(self.shape)


def a_apply(u, nodes8, coeffs8: torch.Tensor) -> torch.Tensor:
    """A u: (N,) -> (m,) trilinear evaluation at the pinned points; for
    z-slabs ``nodes8`` is their ``NodeGather`` and A u lands on the first
    device."""
    if isinstance(u, Shards):
        return (nodes8.values(u) * coeffs8).sum(dim=1)
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


class SlabAt:
    """A^T's table cut per z-slab of ``slab_len`` nodes: each shard's
    touched nodes (slab-local ids), their rows and coefficients, on the
    shard's device."""

    def __init__(self, at: AtTable, mesh, slab_len: int):
        self.mesh, self.slab_len = mesh, slab_len
        self.parts = []
        for k, dev in enumerate(mesh.devices):
            sel = (at.nodes >= k * slab_len) & (at.nodes < (k + 1) * slab_len)
            self.parts.append(AtTable((at.nodes[sel] - k * slab_len).to(dev),
                                      at.rows[sel].to(dev), at.coef[sel].to(dev)))


def at_apply(y: torch.Tensor, at, n: int):
    """A^T y: (m,) -> (N,), a gather over the transposed table written to
    the touched nodes once each.  No two threads add into one address, so
    the sums have one order on every device and in every run (a
    scatter-add through CUDA atomics does not).  With a ``SlabAt`` each
    slab gathers its own nodes and the result is ``Shards``."""
    if isinstance(at, SlabAt):
        return Shards([torch.zeros(at.slab_len, dtype=y.dtype, device=yk.device).index_copy_(
            0, t.nodes, (t.coef * yk[t.rows]).sum(dim=1))
            for t, yk in zip(at.parts, broadcast(y, at.mesh))], at.mesh)
    out = torch.zeros(n, dtype=y.dtype, device=y.device)
    return out.index_copy_(0, at.nodes, (at.coef * y[at.rows]).sum(dim=1))


class TriFactor(NamedTuple):
    """A lower-triangular (m, m) matrix as packed square tiles of side
    TRI_TILE, row-major inside a tile: tile (I, J), J <= I, at index
    I (I + 1) / 2 + J, so a tile row is contiguous.  Diagonal tiles keep
    their zero upper half; the last tile row and column are zero past m."""

    tiles: torch.Tensor  # (nb (nb + 1) / 2, TRI_TILE, TRI_TILE), nb = ceil(m / TRI_TILE)
    m: int


def tri_pack(T: torch.Tensor) -> TriFactor:
    """The lower triangle of the square ``T`` (its strict upper triangle
    is dropped) as a ``TriFactor`` on T's device, one tile row at a time."""
    m = T.shape[0]
    b = TRI_TILE
    nb = -(-m // b)
    tiles = T.new_zeros((nb * (nb + 1) // 2, b, b))
    for i in range(nb):
        r0, r1 = i * b, min((i + 1) * b, m)
        # rows r0..r1 up to the diagonal, padded to i + 1 whole tiles
        blk = torch.nn.functional.pad(T[r0:r1, :r1].tril(r0),
                                      (0, (i + 1) * b - r1, 0, b - (r1 - r0)))
        start = i * (i + 1) // 2
        tiles[start:start + i + 1].copy_(blk.view(b, i + 1, b).transpose(0, 1))
    return TriFactor(tiles, m)


def _tile_rows_cols(f: TriFactor):
    """(tile row I, tile column J) of each packed tile, on its device."""
    n = f.tiles.shape[0]
    nb = -(-f.m // TRI_TILE)
    dev = f.tiles.device
    rows = torch.repeat_interleave(torch.arange(nb, device=dev),
                                   torch.arange(1, nb + 1, device=dev))
    return rows, torch.arange(n, device=dev) - rows * (rows + 1) // 2


def tri_unpack(f: TriFactor) -> torch.Tensor:
    """The dense (m, m) lower-triangular matrix of a ``TriFactor``."""
    b, nb = TRI_TILE, -(-f.m // TRI_TILE)
    rows, cols = _tile_rows_cols(f)
    out = f.tiles.new_zeros((nb, nb, b, b))
    out[rows, cols] = f.tiles
    return out.transpose(1, 2).reshape(nb * b, nb * b)[:f.m, :f.m]


def _blocks(v: torch.Tensor, f: TriFactor) -> torch.Tensor:
    """(m,) as (nb, TRI_TILE) blocks, zero-padded."""
    nb = -(-f.m // TRI_TILE)
    return torch.nn.functional.pad(v, (0, nb * TRI_TILE - f.m)).view(nb, TRI_TILE)


def tri_gemv_torch(f: TriFactor, x: torch.Tensor, trans: bool = False) -> torch.Tensor:
    """T x (T^T x with ``trans``), the kernel's plain version: each tile (or
    its transpose) times its block of x, summed into its tile row (column)."""
    rows, cols = _tile_rows_cols(f)
    src, dst = (rows, cols) if trans else (cols, rows)
    tiles = f.tiles.transpose(1, 2) if trans else f.tiles
    xb = _blocks(x, f)
    prod = torch.bmm(tiles, xb[src].unsqueeze(-1)).squeeze(-1)
    return torch.zeros_like(xb).index_add_(0, dst, prod).reshape(-1)[:f.m]


def tri_gemv_cuda(f: TriFactor, x: torch.Tensor, trans: bool = False) -> torch.Tensor:
    """T x (T^T x with ``trans``) in one launch of the kernel on the current
    stream (float32, one CUDA device); does not synchronize."""
    global TRI_GEMV_LAUNCHES
    device = x.device
    for name, t in (("tiles", f.tiles), ("x", x)):
        if t.device != device or t.device.type != "cuda":
            raise ValueError(f"{name}: expected a CUDA tensor on {device}, got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: the packed-triangle kernel takes float32, got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: expected a contiguous, 16-byte aligned tensor")
    nb = -(-f.m // TRI_TILE)
    if f.tiles.shape != (nb * (nb + 1) // 2, TRI_TILE, TRI_TILE) or x.shape != (f.m,):
        raise ValueError(f"expected ({nb * (nb + 1) // 2}, {TRI_TILE}, {TRI_TILE}) tiles "
                         f"and x of ({f.m},), got {tuple(f.tiles.shape)} and {tuple(x.shape)}")
    y = torch.empty(f.m, dtype=torch.float32, device=device)
    from .._build import load_library

    lib = load_library()
    entry = lib.shm3d_tri_gemv_t_f32 if trans else lib.shm3d_tri_gemv_n_f32
    with torch.cuda.device(device):
        err = entry(ctypes.c_void_p(f.tiles.data_ptr()), ctypes.c_void_p(x.data_ptr()),
                    ctypes.c_void_p(y.data_ptr()), ctypes.c_int64(f.m),
                    ctypes.c_int64(TRI_TILE),
                    ctypes.c_int(device.index if device.index is not None
                                 else torch.cuda.current_device()),
                    ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream))
    if err != 0:
        msg = lib.shm3d_cuda_error_string(err).decode()
        raise RuntimeError(f"packed-triangle kernel launch failed: {msg} ({err})")
    if not graphs.note_launch(__name__, "TRI_GEMV_LAUNCHES"):
        TRI_GEMV_LAUNCHES += 1
    return y


def tri_gemv(f: TriFactor, x: torch.Tensor, trans: bool = False) -> torch.Tensor:
    """T x (T^T x with ``trans``): the plain version for CPU tensors, the
    kernel for CUDA tensors."""
    if x.device.type == "cpu":
        return tri_gemv_torch(f, x, trans)
    if x.device.type == "cuda":
        return tri_gemv_cuda(f, x, trans)
    raise ValueError(f"unsupported device {x.device}")


class GramTable(NamedTuple):
    """Device artifacts of the Gram matrix G = A A^T: its padded (m, K)
    neighbour table and the whitening factor of one tier."""

    idx: torch.Tensor                      # (m, K) int64 column indices, padded 0
    val: torch.Tensor                      # (m, K) values, padded 0.0
    diag: torch.Tensor                     # (m,) diagonal
    bmat: Optional[torch.Tensor] = None    # (r, nt) orthonormalized rows
    touched: Optional[torch.Tensor] = None # (nt,) int64 touched node ids
    # whitening factor: a Cholesky factor's packed lower triangle, or the
    # dense (r, m) factor of the eigendecomposition fallback
    tmat: Optional[Union[TriFactor, torch.Tensor]] = None
    tform_eps: Optional[float] = None      # shift the tmat factor settled on


def gram_apply(y: torch.Tensor, gram: GramTable) -> torch.Tensor:
    """(A A^T) y as an O(m K) gather."""
    return (gram.val * y[gram.idx]).sum(dim=1)


def _gram_table(nodes8: np.ndarray, coeffs8: np.ndarray, n: int):
    """(G = A A^T as CSR, its padded neighbour table {"idx", "val",
    "diag"}) of the sparse rows (nodes8, coeffs8)."""
    import scipy.sparse as sp

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
    return G, {"idx": idx, "val": val, "diag": G.diagonal()}


# copied from shm3d/solve/projection.py (build_gram_arrays), with np.dtype in
# place of jnp.dtype and the table extraction shared (_gram_table)
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
    G, out = _gram_table(nodes8, coeffs8, n)
    d = out["diag"]
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


# copied from shm3d/solve/projection.py (build_tform_arrays), the table
# extraction shared (_gram_table)
def build_tform_arrays(nodes8: np.ndarray, coeffs8: np.ndarray, n: int) -> dict:
    """Compact whitening factor of well-separated pin rows (the subsampled
    tier; ``domains.grid.subsample_pin_rows``): with G = A A^T, D = diag(G)
    and the float64 Cholesky D^-1/2 G D^-1/2 = L L^T, T = L^-1 D^-1/2 makes
    T A a partial isometry, so P = I - A^T T^T T A.  Falls back to a
    truncated eigendecomposition if the Cholesky fails."""
    import scipy.linalg as sla
    import scipy.sparse as sp

    m = nodes8.shape[0]
    G, out = _gram_table(nodes8, coeffs8, n)
    dscale = 1.0 / np.sqrt(out["diag"])
    Gs = (sp.diags(dscale) @ G @ sp.diags(dscale)).toarray()
    try:
        L = sla.cholesky(Gs, lower=True)
        T = sla.solve_triangular(L, np.eye(m), lower=True) * dscale[None, :]
    except np.linalg.LinAlgError:
        lam, Q = np.linalg.eigh(Gs)
        keep = lam > 1e-10 * lam[-1]
        T = (Q[:, keep] / np.sqrt(lam[keep])).T * dscale[None, :]
    out["tmat"] = T
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
    m = 15.8k.  T is lower triangular (L^-1 D^-1/2); the caller packs it."""
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
    fails this warns and returns a table without a factor, so the solver
    takes the host-projected loop for this discretization.

    A lower-triangular factor is packed here, at load, and its square
    freed: the full-row tier's, and a host factor that is square with an
    exactly zero strict upper triangle (``build_tform_arrays``'s Cholesky
    factor; its eigendecomposition fallback is dense and stays so)."""
    idx = torch.as_tensor(np.asarray(arr["idx"]), device=device).long()
    val = torch.as_tensor(np.asarray(arr["val"]), device=device).to(dtype)
    diag = torch.as_tensor(np.asarray(arr["diag"]), device=device).to(dtype)
    bmat = arr.get("bmat")
    touched = arr.get("touched")
    tmat = arr.get("tmat")
    eps = None
    if tmat is not None:
        tmat = np.asarray(tmat)
        lower = tmat.shape[0] == tmat.shape[1] and not np.triu(tmat, 1).any()
        tmat = torch.as_tensor(tmat, device=device).to(dtype)
        if lower:
            tmat = tri_pack(tmat)
    elif arr.get("tform_eps") is not None:
        eps = float(arr["tform_eps"])
        for _ in range(TFORM_EPS_ATTEMPTS):
            tmat = _device_tform(idx, val, diag, eps)
            if tmat is not None:
                tmat = tri_pack(tmat)
                break
            eps *= 10.0
        else:
            warnings.warn(
                f"shm3d_torch: full-row whitening factorization (m={idx.shape[0]}) "
                f"failed at every shift up to {eps / 10.0:g}; falling back to "
                "host-projected solves for this discretization")
            eps = None
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
    ``gram`` (``tmat`` or ``bmat``); ``at`` is A^T's table for ``tmat``.
    With a ``NodeGather`` and a ``SlabAt`` it projects z-slabs.
    A table with neither factor takes the solver's host-projected loop
    instead."""
    if gram.tmat is not None:
        T = gram.tmat
        if isinstance(T, TriFactor):
            def whiten(y):
                return tri_gemv(T, tri_gemv(T, y), trans=True)
        else:
            def whiten(y):
                return T.T @ (T @ y)

        def project_t(v):
            global TMAT_PRODUCTS
            if not graphs.note_launch(__name__, "TMAT_PRODUCTS", 4):
                TMAT_PRODUCTS += 4
            a = a_apply(v, nodes8, coeffs8)
            z = whiten(a)
            # one Gram-refinement step: squares the damping error of the
            # eps-shifted factor and mops up its float32 rounding
            r = a - gram_apply(z, gram)
            z = z + whiten(r)
            return v - at_apply(z, at, n)

        return project_t

    if gram.bmat is None:
        raise ValueError("GramTable has neither bmat nor tmat: project through "
                         "the host factor (host_gram_factor)")
    B = gram.bmat
    if isinstance(nodes8, NodeGather):
        touched = NodeGather(gram.touched[:, None], nodes8.mesh, n // len(nodes8.mesh))

        def project_slabs(v):
            w = B @ touched.values(v)[:, 0]
            corr = -(B.T @ w)
            # each touched node once: the single-device index_add's one
            # addition, without atomics
            return Shards([part.index_copy(0, loc, part[loc] + corr[pos].to(part.device))
                           for part, pos, loc in zip(v.parts, touched.pos, touched.loc)],
                          v.mesh)

        return project_slabs

    def project(v):
        w = B @ v[gram.touched]
        return v.index_add(0, gram.touched, -(B.T @ w))

    return project


# after shm3d/solve/projection.py (host_gram_factor, host_project): the
# exact float64 projection of the defect correction
def host_gram_factor(nodes8: np.ndarray, coeffs8: np.ndarray, n: int):
    """(A, splu(A A^T)) on the host: the sparse rows and the LU factor of
    their sparse Gram matrix, with a 1e-14 shift for exact-duplicate rows.

    The Gram matrix is symmetric positive definite, so SuperLU runs in its
    symmetric mode: a minimum-degree ordering of A A^T applied to rows and
    columns alike, pivots on the diagonal.  On the 52,290-point sphere at
    128^3 (m = 15,706) that halves the factor's fill against the default
    column ordering (2.07M against 4.41M nonzeros in L and U) and with it
    each solve's time, which the defect correction pays eight times a
    solve; the residual stays at round-off (5e-14)."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    m = nodes8.shape[0]
    rows = np.repeat(np.arange(m), 8)
    A = sp.coo_matrix(
        (coeffs8.reshape(-1), (rows, nodes8.reshape(-1))), shape=(m, n)
    ).tocsr()
    gram = (A @ A.T).tocsc()
    gram = gram + 1e-14 * sp.eye(m, format="csc")
    return A, spla.splu(gram, permc_spec="MMD_AT_PLUS_A", diag_pivot_thresh=0.0,
                        options={"SymmetricMode": True})


def host_project(v: np.ndarray, A, gram_lu) -> np.ndarray:
    """Exact float64 P v with the host factorization."""
    return v - A.T @ gram_lu.solve(A @ v)
