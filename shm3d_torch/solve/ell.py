"""Fixed-width (ELL) and sliced-ELL sparse matvecs (port of
shm3d.solve.ell).

The host builders are the JAX package's, copied: ``EllMat`` stores
transposed (w, n) panels plus a row-sorted COO tail for rows wider than the
ELL width, ``SlicedEll`` stores occupancy-sorted row slices of their own
widths, ``CSR64`` is the host f64 operator of the defect correction.  The
builders return numpy leaves in their final dtypes; :func:`device_put_tree`
moves a whole tree of them to one device.

The matvecs are plain torch gathers and sums, as the JAX package computes
them with XLA gathers outside any kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils import tree as tree_mod


@tree_mod.register
class EllMat(NamedTuple):
    """Fixed-width sparse matrix, transposed panels: slot j of row i holds
    entry (cols[j, i], vals[j, i]); padded slots have vals == 0 (cols point
    at 0, harmless under gather).  Rows wider than the ELL width spill into
    the row-sorted COO tail."""

    cols: np.ndarray       # (w, n) int32
    vals: np.ndarray       # (w, n) compute dtype
    tail_rows: np.ndarray  # (t,) int32, row-sorted
    tail_cols: np.ndarray  # (t,) int32
    tail_vals: np.ndarray  # (t,) compute dtype

    @property
    def n_rows(self) -> int:
        return self.cols.shape[1]

    @property
    def width(self) -> int:
        return self.cols.shape[0]


@tree_mod.register
class CSR64(NamedTuple):
    """Host CSR (f64 data, or f32 where stored so; int32 indices): the exact
    operator the f64 defect-correction passes apply on the host."""

    data: np.ndarray
    indices: np.ndarray
    indptr: np.ndarray
    n_rows: int
    n_cols: int

    @staticmethod
    def from_scipy(M, data_dtype=np.float64) -> "CSR64":
        A = M.tocsr()
        # one index dtype for both arrays: scipy unifies mixed index dtypes
        # with a copy, which would defeat a memory-mapped load
        idx = np.int32 if A.nnz < np.iinfo(np.int32).max else np.int64
        return CSR64(np.asarray(A.data, data_dtype),
                     np.asarray(A.indices, idx),
                     np.asarray(A.indptr, idx),
                     int(A.shape[0]), int(A.shape[1]))

    def to_scipy(self):
        import scipy.sparse as sp

        return sp.csr_matrix((self.data, self.indices, self.indptr),
                             shape=(self.n_rows, self.n_cols))


def build_ell(M, dtype, width: int | None = None, percentile: float = 99.5,
              pad_rows_to: int = 1) -> EllMat:
    """Host-side ELL(+tail) build from any scipy sparse matrix, numpy
    leaves in their final dtypes.  ``width`` pins the ELL width; by default
    the narrower of the max row width and the ``percentile`` row width is
    used, except that near-uniform matrices (padding <= 25%) take the full
    width and an empty tail.  ``pad_rows_to`` rounds the panel row count
    (and tail length) up to a multiple with all-zero rows."""
    A = M.tocsr()
    A.sum_duplicates()
    A.sort_indices()
    n = A.shape[0]
    pad = lambda k: -(-k // pad_rows_to) * pad_rows_to
    counts = np.diff(A.indptr)
    nnz = int(A.indices.size)
    if n == 0 or nnz == 0:
        z = np.zeros((1, pad(max(n, 1))))
        return EllMat(z.astype(np.int32), z.astype(dtype),
                      np.zeros(0, np.int32), np.zeros(0, np.int32),
                      np.zeros(0, dtype))
    w_full = int(counts.max())
    if width is not None:
        w = max(1, int(width))
    elif n * w_full <= 1.25 * nnz:
        w = w_full
    else:
        w = max(1, int(np.percentile(counts, percentile)))
    rows_all = np.repeat(np.arange(n, dtype=np.int64), counts)
    pos = np.arange(nnz, dtype=np.int64) - np.repeat(A.indptr[:-1], counts)
    in_ell = pos < w
    cols = np.zeros((w, pad(n)), np.int32)
    vals = np.zeros((w, pad(n)), dtype)
    cols[pos[in_ell], rows_all[in_ell]] = A.indices[in_ell]
    vals[pos[in_ell], rows_all[in_ell]] = A.data[in_ell]
    tail = ~in_ell
    t = int(tail.sum())
    tp = pad(t) if t else 0
    tr = np.zeros(tp, np.int32)
    tc = np.zeros(tp, np.int32)
    tv = np.zeros(tp, dtype)
    # padding goes at the FRONT (row 0, val 0) so the tail stays row-sorted
    tr[tp - t:] = rows_all[tail]
    tc[tp - t:] = A.indices[tail]
    tv[tp - t:] = A.data[tail]
    return EllMat(cols, vals, tr, tc, tv)


def _gather(x: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """x[cols] for an index tensor of any shape (int32 or int64)."""
    return x.index_select(0, cols.reshape(-1)).view(cols.shape)


def fold_tail(m: EllMat) -> EllMat:
    """The same matrix with its COO tail moved into the panel, which widens
    to the widest row (host arrays).

    The port applies no tail on the device: a scatter-add of the tail sums
    repeated rows in an order CUDA atomics do not fix, and float32 CG turns
    such last-bit differences into run-to-run changes of its stopping point
    (measured on the knot_dec face solve: 240 to 558 iterations for one
    input).  Tails occur on operators whose widest row exceeds the 99.5th
    percentile width; the wide ones at scale store as SlicedEll instead, so
    the widened panels stay small."""
    keep = np.asarray(m.tail_vals) != 0       # drops the zero padding entries
    if not keep.any():
        return m if m.tail_rows.shape[0] == 0 else m._replace(
            tail_rows=m.tail_rows[:0], tail_cols=m.tail_cols[:0],
            tail_vals=m.tail_vals[:0])
    rows = np.asarray(m.tail_rows, np.int64)[keep]   # row-sorted
    w0, n = m.cols.shape
    # a tail row fills all w0 panel slots; its tail entries take the next ones
    pos = w0 + np.arange(rows.size) - np.searchsorted(rows, rows, side="left")
    w = int(pos.max()) + 1
    cols = np.zeros((w, n), np.asarray(m.cols).dtype)
    vals = np.zeros((w, n), np.asarray(m.vals).dtype)
    cols[:w0], vals[:w0] = m.cols, m.vals
    cols[pos, rows] = np.asarray(m.tail_cols)[keep]
    vals[pos, rows] = np.asarray(m.tail_vals)[keep]
    return EllMat(cols, vals, m.tail_rows[:0], m.tail_cols[:0], m.tail_vals[:0])


def matvec(m: EllMat, x: torch.Tensor, n_out: int | None = None) -> torch.Tensor:
    """y = M @ x for a panel without a tail (as :func:`device_put_tree`
    leaves it).  ``n_out``: the true output length when the panel rows are
    padded and the matrix is rectangular; it defaults to len(x)."""
    if m.tail_rows.shape[0]:
        raise ValueError("EllMat with a COO tail: move it with device_put_tree, "
                         "which folds the tail into the panel")
    n = x.shape[0] if n_out is None else n_out
    return (m.vals * _gather(x, m.cols)).sum(dim=0)[:n]


@tree_mod.register
class SlicedEll(NamedTuple):
    """Width-skewed sparse matrix as occupancy-sorted row slices: slice s
    stores its rows in a transposed (w_s, n_s) panel whose width is that
    slice's max occupancy.  Application gathers each panel, concatenates,
    and inverse-permutes with one gather (``inv_ids``); rows with no
    entries point at a zero slot appended to the concatenation."""

    cols: tuple          # per slice: (w_s, n_s) int32 panels, widths descending
    vals: tuple          # per slice: (w_s, n_s) compute dtype
    inv_ids: np.ndarray  # (n_rows,) int32: position in the concatenation

    @property
    def n_rows(self) -> int:
        return self.inv_ids.shape[0]

    @property
    def n_slots(self) -> int:
        return sum(int(c.shape[0]) * int(c.shape[1]) for c in self.cols)


def _slice_boundaries(counts_desc: np.ndarray, max_slices: int) -> list:
    """Exact minimum-slot slicing of a descending occupancy sequence (DP
    over the distinct occupancies and the slices used).  Returns row-index
    boundaries [0, b1, ..., n_nonzero_rows]."""
    widths, first = np.unique(-counts_desc, return_index=True)
    widths = -widths                       # descending distinct widths
    if widths.size and widths[-1] == 0:    # zero-occupancy rows: not sliced
        widths, first = widths[:-1], first[:-1]
    m = widths.size
    if m == 0:
        return [0]
    ends = np.append(first[1:], np.searchsorted(-counts_desc, 0, side="left")
                     if counts_desc[-1] == 0 else counts_desc.size)
    n_rows_grp = ends - first
    K = min(max_slices, m)
    INF = float("inf")
    # cost[i][k]: min slots covering groups i.. with k slices left
    cost = [[INF] * (K + 1) for _ in range(m + 1)]
    cut = [[0] * (K + 1) for _ in range(m + 1)]
    for k in range(K + 1):
        cost[m][k] = 0.0
    for i in range(m - 1, -1, -1):
        for k in range(1, K + 1):
            rows = 0
            for j in range(i, m):
                rows += int(n_rows_grp[j])
                c = int(widths[i]) * rows + cost[j + 1][k - 1]
                if c < cost[i][k]:
                    cost[i][k] = c
                    cut[i][k] = j + 1
    bounds = [0]
    i, k = 0, K
    while i < m:
        j = cut[i][k]
        bounds.append(int(ends[j - 1]))
        i, k = j, k - 1
    return bounds


def build_sliced(M, dtype, max_slices: int = 8) -> SlicedEll:
    """Host-side sliced-ELL build from any scipy sparse matrix."""
    A = M.tocsr()
    A.sum_duplicates()
    A.sort_indices()
    n = A.shape[0]
    np_dtype = np.dtype(dtype)
    counts = np.diff(A.indptr)
    order = np.argsort(-counts, kind="stable")
    c_desc = counts[order]
    bounds = _slice_boundaries(c_desc, max_slices)
    cols_s, vals_s = [], []
    nnz = int(A.indices.size)
    rows_all = np.repeat(np.arange(n, dtype=np.int64), counts)
    pos_all = np.arange(nnz, dtype=np.int64) - np.repeat(A.indptr[:-1], counts)
    rank = np.empty(n, np.int64)
    rank[order] = np.arange(n, dtype=np.int64)
    rnk = rank[rows_all]
    for a, b in zip(bounds[:-1], bounds[1:]):
        w = int(c_desc[a])
        cols = np.zeros((max(w, 1), b - a), np.int32)
        vals = np.zeros((max(w, 1), b - a), np_dtype)
        sel = (rnk >= a) & (rnk < b)
        cols[pos_all[sel], rnk[sel] - a] = A.indices[sel]
        vals[pos_all[sel], rnk[sel] - a] = A.data[sel]
        cols_s.append(cols)
        vals_s.append(vals)
    n_sliced = bounds[-1]
    inv = np.full(n, n_sliced, np.int32)   # empty rows -> appended zero slot
    inv[order[:n_sliced]] = np.arange(n_sliced, dtype=np.int32)
    return SlicedEll(tuple(cols_s), tuple(vals_s), inv)


def sliced_matvec(m: SlicedEll, x: torch.Tensor,
                  n_out: int | None = None) -> torch.Tensor:
    """y = M @ x for a SlicedEll."""
    parts = [(v * _gather(x, c)).sum(dim=0) for c, v in zip(m.cols, m.vals)]
    parts.append(x.new_zeros(1))           # slot for empty rows
    y = torch.cat(parts).index_select(0, m.inv_ids)
    return y if n_out is None or n_out == y.shape[0] else y[:n_out]


def sliced_waste(M) -> float:
    """Padding waste factor of the single-width ELL encoding of ``M``
    (max_width * n_rows / nnz)."""
    A = M.tocsr()
    counts = np.diff(A.indptr)
    if A.nnz == 0 or counts.size == 0:
        return 1.0
    return float(int(counts.max()) * A.shape[0]) / float(A.nnz)


def to_scipy(m, shape):
    """The matrix a host EllMat or SlicedEll encodes, as canonical scipy CSR
    of the given shape in the values' dtype (zero slots are padding and are
    dropped; panel rows beyond ``shape[0]`` are padding too)."""
    import scipy.sparse as sp

    if isinstance(m, EllMat):
        m = fold_tail(m)
        panels = [(np.asarray(m.cols), np.asarray(m.vals),
                   np.arange(m.cols.shape[1], dtype=np.int64))]
    else:
        inv = np.asarray(m.inv_ids, np.int64)
        n_sliced = sum(int(c.shape[1]) for c in m.cols)
        row_of = np.empty(n_sliced, np.int64)
        sliced = inv < n_sliced
        row_of[inv[sliced]] = np.flatnonzero(sliced)
        starts = np.cumsum([0] + [int(c.shape[1]) for c in m.cols])
        panels = [(np.asarray(c), np.asarray(v), row_of[a:a + c.shape[1]])
                  for c, v, a in zip(m.cols, m.vals, starts)]
    rows, cols, vals = [], [], []
    for c, v, r in panels:
        keep = v != 0
        rows.append(np.broadcast_to(r, v.shape)[keep])
        cols.append(c[keep])
        vals.append(v[keep])
    A = sp.coo_matrix((np.concatenate(vals),
                       (np.concatenate(rows), np.concatenate(cols))), shape=shape).tocsr()
    A.sort_indices()
    return A


def to_tensor(a: np.ndarray, device) -> torch.Tensor:
    """One numpy array as a tensor of the same dtype on ``device`` (a
    read-only or strided array, e.g. a memory-mapped artifact, is copied
    first)."""
    a = np.asarray(a)
    if not (a.flags.writeable and a.flags.c_contiguous):
        a = np.array(a, order="C")
    return torch.from_numpy(a).to(device)


def _device_form(t):
    """The device encoding of a host operator node: EllMat tails folded
    into their panels (:func:`fold_tail`), PagedMat as sliced ELL
    (``pell.to_sell``), every other node as it is."""
    from . import pell

    if isinstance(t, EllMat):
        return fold_tail(t)
    if isinstance(t, pell.PagedMat):
        return pell.to_sell(t)
    return t


def device_put_tree(tree, device):
    """Every numpy leaf of ``tree`` (dicts, lists, tuples and the port's
    operator types) as a tensor of the same dtype on ``device``, each
    operator node in its device encoding first (:func:`_device_form`).
    Every device takes the same encoding, so the CPU runs the layout the
    card runs, through its plain version."""
    device = torch.device(device)
    return tree_mod.map_arrays(lambda a: to_tensor(a, device), tree,
                               node=_device_form)
