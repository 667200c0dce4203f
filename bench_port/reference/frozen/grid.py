"""Regular-grid background domain.

Reimplements the reference grid construction
(reference src/signed_heat_grid_solver.cpp:13-35,124-143,505-514):

- cube of half-side s = radius * scale about the source centroid,
- nx = ny = nz = 2 * 2**(hCoef + 3)   (h=0 -> 16^3, h=3 -> 128^3, h=4 -> 256^3),
- cellSize = 2 s / (nx - 1),
- flat node index  idx = i + j*ny + k*(nx*ny),
- node position    bboxMin + (i, j, k) * cellSize.

A flat (N,) vector with this index convention reshapes to a (nz, ny, nx)
C-order array with element [k, j, i]; device code operates on that 3-D layout
(x fastest = last axis = TPU lane dimension).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from . import surface as surf


@dataclasses.dataclass(frozen=True)
class GridSpec:
    bbox_min: Tuple[float, float, float]
    cell_size: float
    n: int  # nodes per axis (nx = ny = nz, reference quirk SURVEY.md §7)

    @property
    def shape(self) -> Tuple[int, int, int]:
        # (nz, ny, nx): flat index i + j*n + k*n^2 == C-order [k, j, i].
        return (self.n, self.n, self.n)

    @property
    def total_nodes(self) -> int:
        return self.n ** 3

    def node_positions(self) -> np.ndarray:
        """(N, 3) float64 positions in flat-index order."""
        n = self.n
        r = np.arange(n, dtype=np.float64) * self.cell_size
        k, j, i = np.meshgrid(r, r, r, indexing="ij")  # axes (z, y, x)
        pos = np.stack([i, j, k], axis=-1).reshape(-1, 3)
        return pos + np.asarray(self.bbox_min, dtype=np.float64)[None, :]

    def flat_index(self, i, j, k):
        return i + j * self.n + k * self.n * self.n

    def cell_of(self, q: np.ndarray) -> np.ndarray:
        """(..., 3) -> integer cell indices (i, j, k) = floor((q - bboxMin)/h)."""
        d = (np.asarray(q, dtype=np.float64) - np.asarray(self.bbox_min)) / self.cell_size
        return np.floor(d).astype(np.int64)


def build_grid(positions: np.ndarray, scale: float = 2.0, h_coef: float = 0.0) -> GridSpec:
    """Grid spec from the source geometry's centroid/radius
    (signed_heat_grid_solver.cpp:13-26)."""
    c = surf.centroid(positions)
    r = surf.radius(positions, c)
    s = r * scale
    # hCoef is a float in the reference (nx = 2*pow(2, hCoef+3) computed in
    # floating point, signed_heat_grid_solver.cpp:24); do NOT truncate the
    # exponent or fractional refinement (e.g. --h 1.5) silently coarsens.
    n = int(2 * 2.0 ** (float(h_coef) + 3))
    cell = 2.0 * s / (n - 1)
    bbox_min = tuple((c - s).tolist())
    return GridSpec(bbox_min, cell, n)


# ---------------------------------------------------------------------------
# Host sparse operators (SciPy) — the correctness oracle for the device
# stencil implementations in shm3d/ops/stencil.py, transcribed from
# signed_heat_grid_solver.cpp:278-402.


def laplacian_matrix(grid: GridSpec):
    """Negative-(semi)definite 7-point FD Laplacian with mirrored boundary
    differences, scaled 1/cellSize^2 (signed_heat_grid_solver.cpp:277-334).

    Mirroring detail: at a boundary the off-diagonal entry that would leave
    the grid is redirected to the node itself (summing into the diagonal), so
    boundary rows still sum to zero.
    """
    import scipy.sparse as sp

    n = grid.n
    N = grid.total_nodes
    rows, cols, vals = [], [], []
    idx = lambda i, j, k: i + j * n + k * n * n
    I, J, K = np.meshgrid(np.arange(n), np.arange(n), np.arange(n), indexing="ij")
    I, J, K = I.ravel(), J.ravel(), K.ravel()
    curr = idx(I, J, K)
    for axis, (A, B, C) in enumerate([(I, J, K), (J, I, K), (K, I, J)]):
        # "next" neighbor along axis: mirrored to curr at the far boundary.
        if axis == 0:
            nxt = np.where(I == n - 1, curr, idx(I + 1, J, K))
            prv = np.where(I == 0, curr, idx(np.maximum(I - 1, 0), J, K))
        elif axis == 1:
            nxt = np.where(J == n - 1, curr, idx(I, J + 1, K))
            prv = np.where(J == 0, curr, idx(I, np.maximum(J - 1, 0), K))
        else:
            nxt = np.where(K == n - 1, curr, idx(I, J, K + 1))
            prv = np.where(K == 0, curr, idx(I, J, np.maximum(K - 1, 0)))
        rows.extend([curr, curr])
        cols.extend([nxt, prv])
        vals.extend([np.ones(N), np.ones(N)])
    rows.append(curr)
    cols.append(curr)
    vals.append(-6.0 * np.ones(N))
    L = sp.coo_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))), shape=(N, N)
    ).tocsr()
    return L / (grid.cell_size ** 2)


def gradient_matrix(grid: GridSpec):
    """Forward-difference gradient D (3N x N), mirrored at the far boundary,
    scaled 1/cellSize; rows interleaved (x, y, z) per node
    (signed_heat_grid_solver.cpp:336-402).  At the far boundary the forward
    difference becomes the backward difference (next:=curr, curr:=prev)."""
    import scipy.sparse as sp

    n = grid.n
    N = grid.total_nodes
    idx = lambda i, j, k: i + j * n + k * n * n
    I, J, K = np.meshgrid(np.arange(n), np.arange(n), np.arange(n), indexing="ij")
    I, J, K = I.ravel(), J.ravel(), K.ravel()
    node = idx(I, J, K)
    rows, cols, vals = [], [], []
    for axis in range(3):
        if axis == 0:
            at_end = I == n - 1
            nxt = np.where(at_end, node, idx(np.minimum(I + 1, n - 1), J, K))
            cur = np.where(at_end, idx(np.maximum(I - 1, 0), J, K), node)
        elif axis == 1:
            at_end = J == n - 1
            nxt = np.where(at_end, node, idx(I, np.minimum(J + 1, n - 1), K))
            cur = np.where(at_end, idx(I, np.maximum(J - 1, 0), K), node)
        else:
            at_end = K == n - 1
            nxt = np.where(at_end, node, idx(I, J, np.minimum(K + 1, n - 1)))
            cur = np.where(at_end, idx(I, J, np.maximum(K - 1, 0)), node)
        rows.extend([3 * node + axis, 3 * node + axis])
        cols.extend([nxt, cur])
        vals.extend([np.ones(N), -np.ones(N)])
    D = sp.coo_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))), shape=(3 * N, N)
    ).tocsr()
    return D / grid.cell_size


def trilinear_rows(grid: GridSpec, q: np.ndarray):
    """Trilinear interpolation stencils for query points q (M, 3).

    Returns (node_indices (M, 8) int64, coeffs (M, 8) float64) matching
    trilinearCoefficients (signed_heat_grid_solver.cpp:433-464): corner order
    000,100,010,001,110,101,011,111.
    """
    q = np.asarray(q, dtype=np.float64).reshape(-1, 3)
    ijk = grid.cell_of(q)
    i, j, k = ijk[:, 0], ijk[:, 1], ijk[:, 2]
    p000 = np.asarray(grid.bbox_min)[None, :] + ijk * grid.cell_size
    t = (q - p000) / grid.cell_size
    tx, ty, tz = t[:, 0], t[:, 1], t[:, 2]
    f = grid.flat_index
    nodes = np.stack(
        [
            f(i, j, k), f(i + 1, j, k), f(i, j + 1, k), f(i, j, k + 1),
            f(i + 1, j + 1, k), f(i + 1, j, k + 1), f(i, j + 1, k + 1), f(i + 1, j + 1, k + 1),
        ],
        axis=1,
    )
    coeffs = np.stack(
        [
            (1 - tx) * (1 - ty) * (1 - tz),
            tx * (1 - ty) * (1 - tz),
            (1 - tx) * ty * (1 - tz),
            (1 - tx) * (1 - ty) * tz,
            tx * ty * (1 - tz),
            tx * (1 - ty) * tz,
            (1 - tx) * ty * tz,
            tx * ty * tz,
        ],
        axis=1,
    )
    return nodes, coeffs


def constraint_rows(grid: GridSpec, source_points: np.ndarray):
    """One trilinear equality row per grid cell containing a source point,
    deduplicated by first visit in source order
    (signed_heat_grid_solver.cpp:84-100).  Returns (nodes (M,8), coeffs (M,8))."""
    pts = np.asarray(source_points, dtype=np.float64)
    ijk = grid.cell_of(pts)
    cell_id = grid.flat_index(ijk[:, 0], ijk[:, 1], ijk[:, 2])
    _, first = np.unique(cell_id, return_index=True)
    keep = np.sort(first)  # preserve source order of first visits
    return trilinear_rows(grid, pts[keep])


def subsample_pin_rows(
    grid: GridSpec, nodes8: np.ndarray, coeffs8: np.ndarray, target: int
) -> np.ndarray:
    """Spatially decimate pinning rows to at most ``target`` (sorted indices).

    Used by the at-scale grid Step-3 tier (shm3d.solve.projection): the full
    per-occupied-cell row set is kept for the exact f64 refinement, but the
    f32 device solve pins one cell per s^3-cell brick (smallest s that meets
    the target).  Spatial separation is what makes the subsampled Gram
    well-conditioned (measured cond 1.3e3 at 256^3/SprayBottle vs 1.9e6 for
    the full rows, whose near-parallel adjacent-cell rows form a continuum of
    tiny eigenvalues); within each brick the row whose pin point is most
    cell-interior is kept (max-min trilinear coefficient), pushing kept pin
    points further apart.
    """
    m = nodes8.shape[0]
    if m <= target:
        return np.arange(m)
    base = nodes8.min(axis=1)
    n = grid.n
    ci = base % n
    cj = (base // n) % n
    ck = base // (n * n)
    interior = np.asarray(coeffs8).min(axis=1)
    for s in range(2, n + 1):
        nb = (n + s - 1) // s
        brick = (ci // s) + (cj // s) * nb + (ck // s) * nb * nb
        if np.unique(brick).size <= target:
            order = np.lexsort((-interior, brick))
            b_sorted = brick[order]
            first = np.ones(m, dtype=bool)
            first[1:] = b_sorted[1:] != b_sorted[:-1]
            return np.sort(order[first])
    return np.arange(m)  # unreachable: s = n is a single brick


def evaluate_trilinear(grid: GridSpec, u: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Trilinear evaluation of a node function at points q
    (evaluateFunction, signed_heat_grid_solver.cpp:404-431)."""
    nodes, coeffs = trilinear_rows(grid, q)
    return (np.asarray(u)[nodes] * coeffs).sum(axis=1)
