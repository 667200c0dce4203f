"""Locality orderings for unstructured operators.

The paged-ELL kernel's cost (solve/pell.py) is its pass count: how few
source pages the rows of each 1024-row output tile touch.  Mesh entities
numbered by construction order scatter sources across the index space (the
knot recovery mesh measures a median |col - row| of 12 but a 99th
percentile of 3.6M); a Morton (Z-curve) order on entity positions makes
index distance track spatial distance, which is what bounds the pass count
for FEM operators whose couplings are geometrically local.

Coarse AMG levels have no coordinates by the time they are built, but their
unknowns are aggregates of fine ones — ordering aggregates by their first
(minimum) fine member index inherits the fine level's locality for free
(solve/amg.build_hierarchy_host).
"""

from __future__ import annotations

import numpy as np


def _spread3(x: np.ndarray) -> np.ndarray:
    """Interleave 10 bits with two zero bits each (Morton component)."""
    x = x.astype(np.uint64) & np.uint64(0x3FF)
    x = (x | (x << np.uint64(16))) & np.uint64(0x030000FF)
    x = (x | (x << np.uint64(8))) & np.uint64(0x0300F00F)
    x = (x | (x << np.uint64(4))) & np.uint64(0x030C30C3)
    x = (x | (x << np.uint64(2))) & np.uint64(0x09249249)
    return x


def morton_codes(points: np.ndarray, bits: int = 10) -> np.ndarray:
    """Z-curve codes of (n, 3) positions, quantized to ``bits`` per axis."""
    p = np.asarray(points, np.float64)
    ext = np.ptp(p, axis=0)
    q = ((p - p.min(axis=0)) / np.where(ext > 0, ext, 1.0)
         * ((1 << bits) - 1)).astype(np.uint64)
    return ((_spread3(q[:, 0]) << np.uint64(2))
            | (_spread3(q[:, 1]) << np.uint64(1))
            | _spread3(q[:, 2]))


def morton_order(points: np.ndarray) -> np.ndarray:
    """Permutation ``perm`` with perm[k] = original id at new position k."""
    return np.argsort(morton_codes(points), kind="stable")


def inverse_permutation(perm: np.ndarray) -> np.ndarray:
    inv = np.empty(perm.shape[0], np.int64)
    inv[perm] = np.arange(perm.shape[0], dtype=np.int64)
    return inv


def first_row_order(P) -> np.ndarray:
    """Locality order for the COLUMN space of CSR ``P`` (n x nc): columns
    sorted by their minimum incident row.  With locality-ordered rows this
    transfers that order to the coarse space (empty columns sort last)."""
    C = P.tocsc()
    counts = np.diff(C.indptr)
    first = np.full(C.shape[1], np.iinfo(np.int64).max, np.int64)
    nz = counts > 0
    # CSC column data is row-sorted, so the first entry per column is min
    first[nz] = C.indices[C.indptr[:-1][nz]]
    return np.argsort(first, kind="stable")
