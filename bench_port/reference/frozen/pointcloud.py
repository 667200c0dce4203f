"""Oriented-point-cloud geometry: local triangulation and dual-area weights.

The reference gets per-point quadrature weights from geometry-central's tufted
triangulation of the point cloud (``requireTuftedTriangulation`` +
``vertexDualAreas``, reference src/signed_heat_grid_solver.cpp:149-151,
reference src/signed_heat_tet_solver.cpp:96-97).  That construction
(Sharp & Crane, "A Laplacian for Nonmanifold Triangle Meshes", 2020) builds
per-point one-rings from a LOCAL 2D DELAUNAY triangulation of the k nearest
neighbors projected to a tangent plane, unions them into a triangle soup, and
measures barycentric dual areas on (the tufted cover of) that soup.

This module implements the same construction as a host NumPy module (it is a
preprocessing weight, not a hot path — SURVEY.md §2d):

* each point's Delaunay one-ring is recovered through its local 2D VORONOI
  CELL — batched Sutherland-Hodgman clipping of the plane by the k bisector
  half-planes (vectorized over all P points at once; a per-point
  scipy.spatial.Delaunay loop costs ~20 s at 52k points, the batched clip
  ~0.5 s).  A neighbor is a Delaunay neighbor iff its bisector supports an
  edge of the cell;
* ring triangles are angularly-consecutive Delaunay-neighbor pairs.  A cell
  still touching the bounding box after clipping is OPEN (the point sits on
  the scan boundary): its wrap-around pair is dropped instead of fabricating
  a closing triangle — the k-NN fan this replaces closed every ring and
  over-weighted boundary and high-density regions;
* dual areas are barycentric (1/3 of incident soup areas counted from each
  corner's own ring, i.e. with the soup's natural multiplicity — the
  reference's tufted DOUBLE cover scales all areas by exactly 2, which
  cancels in the Step-2 normalization and in every weighted average).
"""

from __future__ import annotations

import dataclasses

import numpy as np
from scipy.spatial import cKDTree

_K_NEIGHBORS = 30  # geometry-central's default point-cloud neighborhood size.


@dataclasses.dataclass
class LocalTriangulation:
    """Triangle soup from per-point neighborhood fans.

    triangles: (T, 3) int64 indices into the point set.
    areas:     (T,) float64 triangle areas.
    dual_areas:(P,) float64 barycentric dual areas (1/3 of incident areas).
    mean_edge_length: float, mean over all fan edges (timestep heuristic
        analog of meanEdgeLength(tuftedGeom),
        reference src/signed_heat_grid_solver.cpp:151).
    """

    triangles: np.ndarray
    areas: np.ndarray
    dual_areas: np.ndarray
    mean_edge_length: float


def _clip_cells(q: np.ndarray) -> tuple:
    """Batched local 2D Voronoi cells.

    q: (P, k, 2) neighbor coordinates in each point's tangent plane (the
    point itself at the origin).  Clips a bounding square by the k bisector
    half-planes x . n_j <= |q_j|/2 with a vectorized Sutherland-Hodgman pass
    per neighbor (all P polygons at once).

    Returns (verts, vmask, on_box) where verts (P, M, 2) are cell vertices,
    vmask (P, M) marks valid slots, and on_box (P, M) marks vertices still on
    the initial square (an OPEN cell: the point sits on a scan boundary or
    its neighborhood doesn't surround it).
    """
    P, k, _ = q.shape
    qn = np.linalg.norm(q, axis=2)                      # (P, k)
    dup = qn <= 0.0                                     # coincident neighbor
    safe = np.where(dup, 1.0, qn)
    n_hat = q / safe[:, :, None]                        # (P, k, 2)
    d = 0.5 * qn                                        # (P, k)
    # duplicates never clip: push their half-plane to infinity
    d = np.where(dup, np.inf, d)

    R = 2.0 * qn.max(axis=1)                            # (P,)
    R = np.where(R > 0, R, 1.0)
    M = 2 * k + 8                                       # capacity after clips
    verts = np.zeros((P, M, 2))
    square = np.array([[1.0, -1.0], [1.0, 1.0], [-1.0, 1.0], [-1.0, -1.0]])
    verts[:, :4] = square[None, :, :] * R[:, None, None]
    cnt = np.full(P, 4, dtype=np.int64)
    eps = 1e-12 * R                                     # scale-relative

    idx = np.arange(M)
    for j in range(k):
        nj = n_hat[:, j]                                # (P, 2)
        s = verts @ nj[:, :, None]                      # (P, M, 1)
        s = s[:, :, 0] - d[:, j][:, None]               # signed dist
        valid = idx[None, :] < cnt[:, None]
        inside = (s <= eps[:, None]) & valid
        nxt = np.where(valid, (idx[None, :] + 1) % np.maximum(cnt, 1)[:, None], 0)
        s_nxt = np.take_along_axis(s, nxt, axis=1)
        v_nxt = np.take_along_axis(verts, nxt[:, :, None], axis=1)
        inside_nxt = np.take_along_axis(inside, nxt, axis=1)
        crossing = (inside != inside_nxt) & valid
        denom = s - s_nxt
        t = np.where(np.abs(denom) > 0, s / np.where(denom == 0, 1.0, denom), 0.0)
        ipt = verts + t[:, :, None] * (v_nxt - verts)
        # interleave [v_i, intersection_i] then compact kept slots
        cand = np.empty((P, 2 * M, 2))
        cand[:, 0::2] = verts
        cand[:, 1::2] = ipt
        keep = np.empty((P, 2 * M), dtype=bool)
        keep[:, 0::2] = inside
        keep[:, 1::2] = crossing
        order = np.argsort(~keep, axis=1, kind="stable")
        cand = np.take_along_axis(cand, order[:, :, None], axis=1)
        cnt = keep.sum(axis=1)
        verts = cand[:, :M]
    vmask = idx[None, :] < cnt[:, None]
    on_box = vmask & (np.abs(verts).max(axis=2) >= (R * (1.0 - 1e-9))[:, None])
    return verts, vmask, on_box


def local_triangulation(positions: np.ndarray, k: int = _K_NEIGHBORS) -> LocalTriangulation:
    P = positions.shape[0]
    k = min(k, P - 1)
    if k < 2:
        raise ValueError("point cloud too small for local triangulation")
    tree = cKDTree(positions)
    # neighbor index 0 is the point itself.
    _, nbrs = tree.query(positions, k=k + 1, workers=-1)
    nbrs = nbrs[:, 1:]

    # Batched over all P points at once (a per-point Python loop costs ~11 s
    # at 52k points; this path runs inside every cold solve's precompute).
    rel = positions[nbrs] - positions[:, None, :]            # (P, k, 3)
    cov = np.einsum("pki,pkj->pij", rel, rel)                # (P, 3, 3)
    # Tangent plane via PCA: normal = least-significant principal axis.
    _, vecs = np.linalg.eigh(cov)                            # batched eigh
    n = vecs[:, :, 0]
    e1 = vecs[:, :, 2]
    e2 = np.cross(n, e1)
    q = np.stack([
        np.einsum("pki,pi->pk", rel, e1), np.einsum("pki,pi->pk", rel, e2)
    ], axis=2)                                               # (P, k, 2)

    verts, vmask, on_box = _clip_cells(q)

    # Delaunay triangles (p, j, l) are dual to the cell's Voronoi vertices:
    # each interior cell vertex is supported by exactly two bisectors j, l
    # (box vertices mean an open cell there and emit nothing).  This is
    # order-free and handles open scan boundaries without fabricating
    # ring-closing triangles.
    qn = np.linalg.norm(q, axis=2)
    dup = qn <= 0.0
    safe = np.where(dup, 1.0, qn)
    tol = 1e-6 * qn.max(axis=1)                              # (P,)
    tris = []
    chunk = max(1, int(2e7) // max(1, verts.shape[1] * k))
    for s0 in range(0, P, chunk):
        sl = slice(s0, s0 + chunk)
        # |v . n_j - d_j| per (point, cell vertex, neighbor)
        dist = np.abs(
            np.einsum("pmx,pkx->pmk", verts[sl], q[sl] / safe[sl][:, :, None])
            - (0.5 * qn[sl])[:, None, :]
        )
        dist = np.where(dup[sl][:, None, :], np.inf, dist)
        sup = dist <= tol[sl][:, None, None]                 # (p, m, k)
        use = vmask[sl] & ~on_box[sl]
        sup &= use[:, :, None]
        nsup = sup.sum(axis=2)
        # robust pair extraction: the two smallest-distance supporters
        ok = use & (nsup >= 2)
        if not ok.any():
            continue
        pi, mi = np.nonzero(ok)
        two = np.argsort(
            np.where(sup[pi, mi], dist[pi, mi], np.inf), axis=1
        )[:, :2]
        j = nbrs[sl][pi, two[:, 0]]
        l = nbrs[sl][pi, two[:, 1]]
        p_glob = pi + s0
        tris.append(np.stack([p_glob, j, l], axis=1))
    if tris:
        triangles = np.concatenate(tris, axis=0)
        # dedup identical (p, j, l) emitted by numerically duplicate cell
        # vertices (cocircular neighborhoods)
        key = np.stack([triangles[:, 0],
                        np.minimum(triangles[:, 1], triangles[:, 2]),
                        np.maximum(triangles[:, 1], triangles[:, 2])], axis=1)
        _, first = np.unique(key, axis=0, return_index=True)
        triangles = triangles[np.sort(first)]
        good = (triangles[:, 1] != triangles[:, 2]) & \
               (triangles[:, 0] != triangles[:, 1]) & \
               (triangles[:, 0] != triangles[:, 2])
        triangles = triangles[good]
    else:
        triangles = np.empty((0, 3), dtype=np.int64)

    pa = positions[triangles[:, 0]]
    pb = positions[triangles[:, 1]]
    pc = positions[triangles[:, 2]]
    areas = 0.5 * np.linalg.norm(np.cross(pb - pa, pc - pa), axis=1)

    # barycentric dual areas, counted from each corner's own ring: in a
    # consistent Delaunay the same geometric triangle appears in all three
    # corners' rings, so this equals soup-with-multiplicity 1/3-areas (and
    # the reference's tufted DOUBLE cover only doubles the global scale)
    dual = np.zeros(P, dtype=np.float64)
    np.add.at(dual, triangles[:, 0], areas / 3.0)

    if len(triangles):
        edge_len = (
            np.linalg.norm(pb - pa, axis=1).sum()
            + np.linalg.norm(pc - pb, axis=1).sum()
            + np.linalg.norm(pa - pc, axis=1).sum()
        ) / (3 * len(triangles))
    else:
        edge_len = 0.0
    return LocalTriangulation(triangles, areas, dual, float(edge_len))


def point_dual_areas(positions: np.ndarray, k: int = _K_NEIGHBORS) -> np.ndarray:
    return local_triangulation(positions, k).dual_areas


def connected_components(positions: np.ndarray, k: int = _K_NEIGHBORS) -> np.ndarray:
    """Per-point component labels over the local-triangulation neighbor graph
    (the reference walks the tufted triangulation's vertex adjacency for its
    Multiple-constraint rows, signed_heat_tet_solver.cpp:353-381).  Labels
    are numbered in order of first appearance."""
    import scipy.sparse as sp
    import scipy.sparse.csgraph as csgraph

    tri = local_triangulation(positions, k).triangles
    P = positions.shape[0]
    rows = np.concatenate([tri[:, 0], tri[:, 1], tri[:, 2]])
    cols = np.concatenate([tri[:, 1], tri[:, 2], tri[:, 0]])
    g = sp.coo_matrix((np.ones(rows.shape[0]), (rows, cols)), shape=(P, P))
    _, labels = csgraph.connected_components(g, directed=False)
    # renumber by first appearance
    first = {}
    out = np.empty(P, dtype=np.int64)
    for i, l in enumerate(labels):
        if l not in first:
            first[l] = len(first)
        out[i] = first[l]
    return out
