"""Isosurface extraction: vectorized marching tetrahedra (+ grid contouring).

The reference extracts isosurfaces two ways:
- tet path: ``igl::marching_tets(vertices, tets, phi, isoval)``
  (reference src/signed_heat_tet_solver.cpp:812-822),
- grid path: Polyscope's built-in marching cubes on the node grid
  (reference src/main.cpp:120-124).

Here a single vectorized marching-tetrahedra primitive covers both: the grid
path decomposes each cube cell crossing the isovalue into 6 Kuhn tetrahedra
(host prefilter keeps only crossing cells, so memory scales with surface area
rather than volume).  Unlike libigl we orient every output triangle so its
normal points toward increasing phi (outward for a signed distance field).

Output is a welded mesh (unique vertices keyed by the global edge each vertex
lies on, matching marching-tets vertex identification).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

# tet edges as (vertex, vertex) index pairs
_TET_EDGES = np.array([(0, 1), (1, 2), (2, 0), (0, 3), (1, 3), (2, 3)], dtype=np.int64)


def _case_table():
    """For each of the 16 inside-masks, list up to 2 triangles as triples of
    tet-edge indices (-1 padded), wound so that on a POSITIVELY oriented tet
    the triangle normals point toward phi > isoval.

    The winding parity is baked in COMBINATORIALLY (igl-style): it is
    derived once on a canonical positive tet — where the linear gradient is
    well-conditioned — and is invariant over all nondegenerate positively
    oriented tets with the same mask (the sign of n . grad(phi) is a
    continuous nonvanishing functional on that connected set).  Runtime
    then only flips triangles from negative-volume tets.  (A per-triangle
    runtime orientation against the tet's phi-gradient was used before and
    misoriented faces generated by near-coplanar SLIVER tets, where the
    interpolant's gradient direction is numerically meaningless — 52 of
    3.1k faces on a snapped-lattice sphere fixture, tests/test_contour.py.)"""
    table = np.full((16, 2, 3), -1, dtype=np.int64)
    edge_of = {tuple(sorted(e)): i for i, e in enumerate(map(tuple, _TET_EDGES))}
    ref = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0],
                    [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]])  # det = +1

    def oriented(es, phi_ref):
        # crossing points at t=1/2 on the reference tet; wind toward phi>0
        pts = np.array([(ref[_TET_EDGES[e][0]] + ref[_TET_EDGES[e][1]]) / 2.0
                        for e in es])
        g, *_ = np.linalg.lstsq(ref[1:] - ref[0], phi_ref[1:] - phi_ref[0],
                                rcond=None)
        n = np.cross(pts[1] - pts[0], pts[2] - pts[0])
        return es if float(n @ g) > 0 else [es[0], es[2], es[1]]

    for mask in range(1, 15):
        inside = [v for v in range(4) if mask & (1 << v)]
        outside = [v for v in range(4) if not (mask & (1 << v))]
        phi_ref = np.array([-1.0 if mask & (1 << v) else 1.0
                            for v in range(4)])
        if len(inside) == 1:
            a = inside[0]
            es = [edge_of[tuple(sorted((a, o)))] for o in outside]
            table[mask, 0] = oriented(es, phi_ref)
        elif len(inside) == 3:
            a = outside[0]
            es = [edge_of[tuple(sorted((a, i)))] for i in inside]
            table[mask, 0] = oriented(es, phi_ref)
        else:  # two inside, two outside -> quad
            a, b = inside
            c, d = outside
            quad = [
                edge_of[tuple(sorted((a, c)))],
                edge_of[tuple(sorted((a, d)))],
                edge_of[tuple(sorted((b, d)))],
                edge_of[tuple(sorted((b, c)))],
            ]
            table[mask, 0] = oriented([quad[0], quad[1], quad[2]], phi_ref)
            table[mask, 1] = oriented([quad[0], quad[2], quad[3]], phi_ref)
    return table


_CASE_TABLE = _case_table()


def marching_tets(
    vertices: np.ndarray,
    tets: np.ndarray,
    phi: np.ndarray,
    isoval: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Extract the isosurface of a piecewise-linear field on a tet mesh.

    Returns (iso_vertices (M, 3), iso_faces (K, 3)) with welded vertices and
    triangles oriented with normals pointing toward phi > isoval.
    """
    vertices = np.asarray(vertices, dtype=np.float64)
    tets = np.asarray(tets, dtype=np.int64)
    phi = np.asarray(phi, dtype=np.float64)

    pv = phi[tets]  # (T, 4)
    mask = ((pv < isoval) << np.arange(4)[None, :]).sum(axis=1)  # (T,)
    active = (mask > 0) & (mask < 15)
    if not np.any(active):
        return np.zeros((0, 3)), np.zeros((0, 3), dtype=np.int64)
    tets_a = tets[active]
    mask_a = mask[active]

    tris_e = _CASE_TABLE[mask_a]  # (Ta, 2, 3) edge indices
    valid_tri = tris_e[:, :, 0] >= 0  # (Ta, 2)

    # Global edge endpoints for each referenced tet edge.
    ev = _TET_EDGES[tris_e.clip(min=0)]  # (Ta, 2, 3, 2) local vertex pairs
    gva = np.take_along_axis(tets_a[:, None, None, :], ev[..., :1], axis=3)[..., 0]
    gvb = np.take_along_axis(tets_a[:, None, None, :], ev[..., 1:], axis=3)[..., 0]

    ta, tb = np.minimum(gva, gvb), np.maximum(gva, gvb)
    tri_sel = valid_tri.reshape(-1)
    ea = ta.reshape(-1, 3)[tri_sel]
    eb = tb.reshape(-1, 3)[tri_sel]

    # Interpolated crossing point on each (a, b) edge.
    pa, pb = phi[ea], phi[eb]
    t = (isoval - pa) / (pb - pa)
    pts = vertices[ea] + t[..., None] * (vertices[eb] - vertices[ea])  # (K, 3, 3)

    # Orient: the case table is wound for positively oriented tets (see
    # _case_table — combinatorial parity, immune to sliver-tet gradient
    # noise); flip triangles generated by negative-volume tets.
    tet_ids = np.repeat(np.arange(tets_a.shape[0]), 2)[tri_sel]
    verts_t = vertices[tets_a[tet_ids]]  # (K, 4, 3)
    E = verts_t[:, 1:] - verts_t[:, :1]  # (K, 3, 3) edge rows
    vol = np.einsum("ij,ij->i", np.cross(E[:, 0], E[:, 1]), E[:, 2])
    flip = vol < 0
    pts[flip] = pts[flip][:, [0, 2, 1]]
    ea_k = np.where(flip[:, None], ea[:, [0, 2, 1]], ea)
    eb_k = np.where(flip[:, None], eb[:, [0, 2, 1]], eb)

    # Weld vertices by global edge key (a, b).
    keys = ea_k.astype(np.int64) * (vertices.shape[0] + 1) + eb_k.astype(np.int64)
    uniq, inv = np.unique(keys.reshape(-1), return_inverse=True)
    iso_faces = inv.reshape(-1, 3)
    iso_vertices = np.zeros((uniq.shape[0], 3))
    iso_vertices[inv.reshape(-1)] = pts.reshape(-1, 3)

    # Drop degenerate triangles (two corners welded to the same point).
    good = (
        (iso_faces[:, 0] != iso_faces[:, 1])
        & (iso_faces[:, 1] != iso_faces[:, 2])
        & (iso_faces[:, 0] != iso_faces[:, 2])
    )
    return iso_vertices, iso_faces[good]


# Kuhn decomposition of the unit cube into 6 tetrahedra sharing the main
# diagonal (0,0,0)-(1,1,1).  Corner order: c = i + 2j + 4k (x fastest).
_KUHN_TETS = np.array(
    [
        [0, 1, 3, 7],
        [0, 3, 2, 7],
        [0, 2, 6, 7],
        [0, 6, 4, 7],
        [0, 4, 5, 7],
        [0, 5, 1, 7],
    ],
    dtype=np.int64,
)
_CUBE_CORNERS = np.array(
    [[i, j, k] for k in (0, 1) for j in (0, 1) for i in (0, 1)], dtype=np.int64
)  # corner c=(i + 2j + 4k) -> offset (i, j, k)


def grid_isosurface(grid, phi_flat: np.ndarray, isoval: float = 0.0):
    """Marching-tets contouring of a grid node field (grid-path analog of the
    Polyscope marching cubes the reference delegates to, main.cpp:120-124).

    ``grid`` is a shm3d.domains.grid.GridSpec; ``phi_flat`` uses the flat
    reference node ordering.  Only cells whose corner values straddle
    ``isoval`` generate tets (host prefilter).
    """
    n = grid.n
    phi3 = np.asarray(phi_flat, dtype=np.float64).reshape(grid.shape)  # [k, j, i]

    # corner min/max per cell
    c = phi3
    sub = [c[:-1, :-1, :-1], c[:-1, :-1, 1:], c[:-1, 1:, :-1], c[:-1, 1:, 1:],
           c[1:, :-1, :-1], c[1:, :-1, 1:], c[1:, 1:, :-1], c[1:, 1:, 1:]]
    cmin = np.minimum.reduce(sub)
    cmax = np.maximum.reduce(sub)
    kk, jj, ii = np.nonzero((cmin <= isoval) & (cmax >= isoval))
    if len(ii) == 0:
        return np.zeros((0, 3)), np.zeros((0, 3), dtype=np.int64)

    # global node indices of the 8 corners of each crossing cell
    ci = ii[:, None] + _CUBE_CORNERS[None, :, 0]
    cj = jj[:, None] + _CUBE_CORNERS[None, :, 1]
    ck = kk[:, None] + _CUBE_CORNERS[None, :, 2]
    corner_nodes = ci + cj * n + ck * n * n  # (C, 8) flat reference indices

    tets = corner_nodes[:, _KUHN_TETS].reshape(-1, 4)  # (C*6, 4)
    node_pos = grid.node_positions()
    return marching_tets(node_pos, tets, np.asarray(phi_flat, dtype=np.float64), isoval)
