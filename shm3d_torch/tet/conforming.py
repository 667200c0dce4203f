"""Surface recovery: make the stuffing lattice conform to the source mesh.

The reference gets a surface-conforming tet mesh from TetGen's constrained
Delaunay with facet preservation (TETFLAGS_PRESERVE "...Y",
reference src/signed_heat_tet_solver.cpp:885-1016); the surface faces
are then identified with orientation signs (:983-1011) and drive the default
Crouzeix-Raviart Step 3 (:234-317).  This module is the TPU-era equivalent
built on the Kuhn-lattice stuffing mesh (shm3d.tet.mesher): instead of a
Delaunay boundary recovery, constraints are recovered by **Steiner insertion
on the constraint itself** using the mesher's exact split primitives:

1. **Edge recovery** — for each source edge (a, b): walk from a toward b;
   each step exits the current vertex's tet star through the face opposite
   the vertex (a ray from a tet vertex into the tet always exits through the
   opposite face), inserts the exit point (which lies ON the segment) as a
   mesh vertex, and continues.  The source edge becomes a chain of mesh
   edges whose Steiner vertices all lie exactly on the segment.

2. **Face recovery** — for each source triangle F (its boundary now a chain
   of mesh edges): repeatedly find mesh edges that *pierce* the interior of
   F (endpoints strictly on opposite sides of F's plane, crossing point
   inside F) and insert the crossing point (which lies ON F).  Once no mesh
   edge pierces F, F is exactly tiled by tet faces: any tet crossed by F
   would yield a cut polygon whose corners sit on tet edges (eliminated) or
   tet vertices, and a plane through >= 3 vertices of a tet is a face plane.

3. **Extraction** — collect, per input face, the tet faces whose vertices
   lie on its plane with barycenter inside it; verify the sub-face areas sum
   to the input face area (rel 1e-6) — the conformity certificate.

Every insertion point lies on the constraint, so input faces are only ever
*subdivided*, never displaced: the recovered surface is geometrically the
input surface, which is exactly what the CR constraint semantics need.
Splits only create edges interior to existing tets, so recovered constraints
can never be broken by later recovery (monotone progress).  Near-degenerate
crossings snap unconstrained lattice vertices onto the constraint instead of
splitting (isosurface-stuffing-style warping), which avoids slivers.

Failure (grazing degeneracies, walk stalls) raises ConformingError and the
caller falls back to the non-conforming vertex-path mesh — the same
degradation the reference applies on TetGen failure (:24-33,966-977).

Known limitation (measured on the reference's scanned assets bunny_small/
knot/rocker/chair): recovery completes with machine-precision certificates
on well-resolved geometry (icosphere-class meshes, lattice-aligned
fixtures) but stalls on raw scans whose local feature separations fall
below the lattice dedup scale — constrained Steiner points from adjacent
chains crowd into pockets where insertion must snap, flips would remove
previously-recovered edges, and repair becomes order-dependent.  The native
walk carries a repertoire of repairs (corridor hop, pancake weld, needle
collapse, 2-3 flip connect, parameter-nudge escape, landing-ball collapse)
that each resolve some configurations; finishing arbitrary scans needs
exact orientation predicates and proper constrained-Delaunay recovery (a
TetGen-scale subsystem, planned).  Grid-domain solves and the tet vertex
path are unaffected.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from .mesher import ConformingError, _MeshBuilder, _norm3

# Recovery tolerance ladder (all absolute distances scale with the cell h):
#   delta_p  <= ~1e-7 h : feature-projection displacement of inserted points
#                         (insert_point(project=True) with _INSERT_EPS bary
#                         classification)
#   _DEDUP   =  1e-9 h  : recovery points this close to an existing vertex
#                         reuse it (kills micro-slivers)
#   _TOL_P   =  1e-6 h  : piercing threshold — an edge endpoint within
#                         _TOL_P of the plane counts as touching (its vertex
#                         is a tiling corner), not crossing; must exceed
#                         delta_p so projected chain vertices never register
#                         as crossings
#   _TOL_E   =  1e-5 h  : on-plane membership for tiling extraction and
#                         constrained-marking; must exceed _TOL_P
#   _CERT    =  1e-4    : relative area-certificate slack (gaps from
#                         touch-resolved crossings are O(_TOL_P * perimeter))
# Scale rationale: double-precision tet volumes carry absolute noise of
# ~1e-13 h^3 (error ~1e-16 * edge^2 * coord), so features thinner than
# ~1e-5 h cannot be reliably validated; the ladder sits above that floor.
# The recovered surface may deviate from the input by <= ~_TOL_E h, far
# below the O(h^2) FEM discretization error.
_INSERT_EPS = 1e-7
_DEDUP = 1e-9
_TOL_P = 1e-6
_TOL_E = 1e-5
_CERT = 1e-4
# max snap displacement for recovery warping, as a fraction of the cell
_SNAP_FRAC = 0.15


def recover_surface(mb: _MeshBuilder, vertex_of: np.ndarray,
                    src_points: np.ndarray, src_faces: np.ndarray,
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Recover every source edge and face; returns (surface_tris (S, 3)
    builder vertex ids, surface_parent (S,) input face indices).
    Raises ConformingError on failure."""
    faces = np.asarray(src_faces, dtype=np.int64)
    if faces.size == 0:
        raise ConformingError("no source faces")
    vmap = np.asarray(vertex_of, dtype=np.int64)
    snap_tol = _SNAP_FRAC * mb.h

    # --- 1. edges (all faces' edges first: face recovery assumes recovered
    # boundaries, and edge walks insert points only on their own segment)
    E = faces[:, [[0, 1], [1, 2], [2, 0]]].reshape(-1, 2)
    E = vmap[E]
    E.sort(axis=1)
    E = np.unique(E, axis=0)
    E = E[E[:, 0] != E[:, 1]]  # coincident inputs dedup to one mesh vertex
    for u, v in E:
        _recover_edge(mb, int(u), int(v), snap_tol)

    # --- 2. faces
    fverts = vmap[faces]
    for fi in range(faces.shape[0]):
        v0, v1, v2 = (int(x) for x in fverts[fi])
        if v0 == v1 or v1 == v2 or v0 == v2:
            continue  # degenerate input face
        _recover_face(mb, v0, v1, v2, snap_tol)

    # --- 3. extraction + certificate
    tris: List[np.ndarray] = []
    parents: List[np.ndarray] = []
    for fi in range(faces.shape[0]):
        v0, v1, v2 = (int(x) for x in fverts[fi])
        if v0 == v1 or v1 == v2 or v0 == v2:
            continue
        sub = _extract_subfaces(mb, v0, v1, v2, fi)
        tris.append(sub)
        parents.append(np.full(sub.shape[0], fi, dtype=np.int64))
    if not tris:
        raise ConformingError("no recoverable faces")
    return np.concatenate(tris, axis=0), np.concatenate(parents, axis=0)


# ---------------------------------------------------------------------------
# edges


def _recover_edge(mb: _MeshBuilder, va: int, vb: int, snap_tol: float) -> None:
    pb = mb.vert(vb).copy()
    cur = va
    for _ in range(4096):
        if cur == vb or mb.edge_exists(cur, vb):
            return
        pc = mb.vert(cur).copy()
        seg = pb - pc
        seg_len = _norm3(seg)
        if seg_len <= 1e-14 * mb.h:
            return  # numerically at the target
        # probe one cell along the segment: barycentric magnitudes stay O(1),
        # so the cone-membership tolerance is scale-correct
        probe = pc + (mb.h / seg_len) * seg
        best_s = None
        best_tid = -1
        for tol in (1e-9, 1e-6, 1e-4):
            for tid in mb.vert_tets(cur):
                t = mb.tet_verts(tid)
                li = t.index(cur)
                bet = mb._bary(tid, probe)
                if any(bet[j] < -tol for j in range(4) if j != li):
                    continue  # segment leaves this tet immediately
                if bet[li] >= 1.0 - 1e-15:
                    continue
                # exit through the face opposite cur, in probe-parameterization
                sigma = 1.0 / (1.0 - bet[li])
                s = sigma * mb.h / seg_len  # convert to (pc -> pb) param
                if best_s is None or s > best_s:
                    best_s = s
                    best_tid = tid
            if best_s is not None:
                break
        if best_s is None or best_s <= 1e-12:
            raise ConformingError(f"edge walk stuck at vertex {cur}")
        q = pc + min(best_s, 1.0) * (pb - pc)
        vid, how = mb.insert_point(q, _INSERT_EPS, snap_tol=snap_tol,
                                   dedup_tol=_DEDUP * mb.h, project=True)
        if vid == cur:
            # blocked by micro-geometry around cur; in preference order:
            # hop through an existing vertex lying in the segment corridor
            # (adjacent chains leave reusable Steiner points there), weld
            # the grazing pancake away, collapse a needle edge, or force a
            # split
            hop = _corridor_hop(mb, cur, pc, seg, seg_len)
            if hop >= 0:
                mb.constrained.add(hop)
                cur = hop
                continue
            if mb.weld_vertex_face(cur, best_tid):
                continue
            if _collapse_near(mb, cur):
                continue
            vid, how = mb.insert_point(q, _INSERT_EPS, snap_tol=0.0,
                                       dedup_tol=0.0, project=True)
        mb.constrained.add(vid)
        if vid == cur:
            raise ConformingError("edge walk made no progress")
        cur = vid
    raise ConformingError("edge walk exceeded step guard")


def _corridor_hop(mb: _MeshBuilder, cur: int, pc, seg, seg_len: float) -> int:
    """Farthest star vertex of cur lying within the segment corridor
    (perpendicular distance <= _TOL_E/2 * h, forward progress); the chain
    bends by at most the corridor radius — inside the extraction
    tolerance.  Returns -1 when none."""
    radius = 0.5 * _TOL_E * mb.h
    best_w, best_t = -1, 0.0
    for tid in mb.vert_tets(cur):
        for w in mb.tet_verts(tid):
            if w == cur:
                continue
            d = mb.verts_of(np.array([w]))[0] - pc
            t_along = float(d[0] * seg[0] + d[1] * seg[1] + d[2] * seg[2]) / seg_len
            if t_along <= 1e-12 * mb.h or t_along > seg_len * (1.0 + 1e-12):
                continue
            dd = float(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
            perp2 = dd - t_along * t_along
            if perp2 > radius * radius:
                continue
            if t_along > best_t:
                best_w, best_t = int(w), t_along
    return best_w


def _collapse_micro(mb: _MeshBuilder, x) -> bool:
    """Collapse the shortest collapsible edge among tets near point x
    (micro-geometry removal so a blocked insert can be retried)."""
    cap = 1e-3 * mb.h
    best = None
    best_d = cap
    for tid in mb.nearby_tets(x, rings=0) or mb.nearby_tets(x, rings=1):
        t = mb.tet_verts(tid)
        for i in range(4):
            for j in range(i + 1, 4):
                u, v = t[i], t[j]
                d = _norm3(mb.vert(u) - mb.vert(v))
                if d >= best_d:
                    continue
                if u not in mb.constrained:
                    best, best_d = (u, v), d
                elif v not in mb.constrained:
                    best, best_d = (v, u), d
    return best is not None and mb.collapse_into(best[0], best[1])


def _collapse_near(mb: _MeshBuilder, cur: int) -> bool:
    """Collapse the nearest unconstrained star vertex into cur (micro-needle
    removal; bend bounded by the 1e-3 h cap, far under the cell size)."""
    pc = mb.vert(cur)
    best_w, best_d = -1, 1e-3 * mb.h
    for tid in mb.vert_tets(cur):
        for v in mb.tet_verts(tid):
            if v == cur or v in mb.constrained:
                continue
            d = _norm3(mb.vert(v) - pc)
            if d < best_d:
                best_w, best_d = v, d
    return best_w >= 0 and mb.collapse_into(best_w, cur)


# ---------------------------------------------------------------------------
# faces


def _face_candidate_tets(mb: _MeshBuilder, pa, pb, pc) -> List[int]:
    lo = np.minimum(np.minimum(pa, pb), pc)
    hi = np.maximum(np.maximum(pa, pb), pc)
    ilo = np.clip(np.floor((lo - mb.bmin) / mb.h).astype(np.int64) - 1, 0, mb.nl - 1)
    ihi = np.clip(np.floor((hi - mb.bmin) / mb.h).astype(np.int64) + 1, 0, mb.nl - 1)
    return mb.live_tets_in_cells(
        range(int(ilo[0]), int(ihi[0]) + 1),
        range(int(ilo[1]), int(ihi[1]) + 1),
        range(int(ilo[2]), int(ihi[2]) + 1),
    )


def _dot3(P: np.ndarray, n) -> np.ndarray:
    """Row-wise dot product in C++-matching scalar order (elementwise numpy
    ops round identically to the native core's left-associated dot; a
    BLAS-backed ``@`` does not)."""
    return P[..., 0] * n[0] + P[..., 1] * n[1] + P[..., 2] * n[2]


def _tri_bary(X: np.ndarray, a, b, c):
    """Barycentric coordinates of (projected) points X in triangle (a,b,c)."""
    v0, v1 = b - a, c - a
    d00 = float(v0[0] * v0[0] + v0[1] * v0[1] + v0[2] * v0[2])
    d01 = float(v0[0] * v1[0] + v0[1] * v1[1] + v0[2] * v1[2])
    d11 = float(v1[0] * v1[0] + v1[1] * v1[1] + v1[2] * v1[2])
    den = d00 * d11 - d01 * d01
    if den <= 0.0:
        z = np.full(X.shape[0] if X.ndim > 1 else 1, -1.0)
        return z, z, z
    v2 = X - a
    d20 = _dot3(v2, v0)
    d21 = _dot3(v2, v1)
    beta = (d11 * d20 - d01 * d21) / den
    gamma = (d00 * d21 - d01 * d20) / den
    return 1.0 - beta - gamma, beta, gamma


_EDGE_IDX = np.array([[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]])


def _recover_face(mb: _MeshBuilder, v0: int, v1: int, v2: int,
                  snap_tol: float) -> None:
    a, b, c = mb.vert(v0).copy(), mb.vert(v1).copy(), mb.vert(v2).copy()
    nrm = np.cross(b - a, c - a)
    nn = _norm3(nrm)
    if nn <= 1e-300:
        return  # zero-area face: nothing to recover
    nrm = nrm / nn
    tolp = _TOL_P * mb.h
    tole = _TOL_E * mb.h

    resolved = set()  # edges whose crossing grazes an on-plane vertex
    for _ in range(64):
        tids = _face_candidate_tets(mb, a, b, c)
        T = mb.tets_of(tids)
        E = T[:, _EDGE_IDX].reshape(-1, 2)
        E.sort(axis=1)
        E = np.unique(E, axis=0)
        p0 = mb.verts_of(E[:, 0])
        p1 = mb.verts_of(E[:, 1])
        d0 = _dot3(p0 - a, nrm)
        d1 = _dot3(p1 - a, nrm)
        crossing = ((d0 > tolp) & (d1 < -tolp)) | ((d0 < -tolp) & (d1 > tolp))
        if not crossing.any():
            break
        idx = np.nonzero(crossing)[0]
        t = d0[idx] / (d0[idx] - d1[idx])
        X = p0[idx] + t[:, None] * (p1[idx] - p0[idx])
        al, be, ga = _tri_bary(X, a, b, c)
        inside = (al >= -1e-7) & (be >= -1e-7) & (ga >= -1e-7)
        progressed = 0
        pending = 0
        for row, x in zip(idx[inside], X[inside]):
            ekey = (int(E[row, 0]), int(E[row, 1]))
            if ekey in resolved:
                continue
            pending += 1
            vid, how = mb.insert_point(x, _INSERT_EPS, snap_tol=snap_tol,
                                       dedup_tol=_DEDUP * mb.h, project=True)
            if how == "dedup" and _norm3(mb.vert(vid) - x) > _TOL_E * mb.h:
                # blocked by micro-geometry (fallback dedup to a far vertex):
                # collapse the local micro-edge and retry once
                if _collapse_micro(mb, x):
                    vid, how = mb.insert_point(x, _INSERT_EPS, snap_tol=snap_tol,
                                               dedup_tol=_DEDUP * mb.h, project=True)
            mb.constrained.add(vid)
            if how != "dedup":
                progressed += 1
            else:
                # grazing: the crossing point landed on an existing vertex
                # (on-plane: a tiling corner — the edge touches, not
                # pierces) or no valid split existed in the local
                # micro-geometry.  Either way mark the edge resolved and let
                # the area certificate arbitrate: an unresolved pierce
                # inside micro-geometry leaves a sub-tolerance hole, while
                # a material hole fails the certificate and falls back.
                resolved.add(ekey)
                progressed += 1
        if pending == 0:
            break  # every remaining crossing is graze-resolved
        if progressed == 0:
            raise ConformingError("face recovery stalled on a grazing edge")
    else:
        raise ConformingError("face recovery exceeded pass guard")

    # mark the tiling vertices constrained so later snaps can't pull them
    # off this plane (they may be plain lattice nodes that happened to lie
    # on the surface, or dedup targets of crossing points)
    tids = _face_candidate_tets(mb, a, b, c)
    vids = np.unique(mb.tets_of(tids))
    P = mb.verts_of(vids)
    onp = np.abs(_dot3(P - a, nrm)) <= _TOL_E * mb.h
    al, be, ga = _tri_bary(P, a, b, c)
    inside = (al >= -1e-6) & (be >= -1e-6) & (ga >= -1e-6)
    for v in vids[onp & inside]:
        mb.constrained.add(int(v))


def _extract_subfaces(mb: _MeshBuilder, v0: int, v1: int, v2: int,
                      fi: int) -> np.ndarray:
    """Tet faces tiling input face fi; raises ConformingError when the tile
    areas don't sum to the face area (conformity certificate)."""
    a, b, c = mb.vert(v0).copy(), mb.vert(v1).copy(), mb.vert(v2).copy()
    nrm = np.cross(b - a, c - a)
    area = 0.5 * _norm3(nrm)
    if area <= 0.0:
        return np.empty((0, 3), dtype=np.int64)
    nrm = nrm / (2.0 * area)
    tole = _TOL_E * mb.h

    tids = _face_candidate_tets(mb, a, b, c)
    T = mb.tets_of(tids)
    vids, inv = np.unique(T, return_inverse=True)
    P = mb.verts_of(vids)
    onp = np.abs(_dot3(P - a, nrm)) <= tole
    onp_T = onp[inv].reshape(T.shape)  # (K, 4)

    # faces opposite each corner (mesher._OPP order not needed; any triple)
    tri_list = []
    for jz in range(4):
        idx = [j for j in range(4) if j != jz]
        mask = onp_T[:, idx].all(axis=1)
        if mask.any():
            tri_list.append(T[mask][:, idx])
    if not tri_list:
        raise ConformingError(f"face {fi}: no on-plane tet faces found")
    tris = np.concatenate(tri_list, axis=0)
    # barycenter inside the input face
    centers = mb.verts_of(tris.reshape(-1)).reshape(-1, 3, 3).mean(axis=1)
    al, be, ga = _tri_bary(centers, a, b, c)
    inside = (al >= -1e-7) & (be >= -1e-7) & (ga >= -1e-7)
    tris = tris[inside]
    if tris.shape[0] == 0:
        raise ConformingError(f"face {fi}: no sub-faces inside the face")
    # dedup (each interior sub-face is seen from both sides)
    st = np.sort(tris, axis=1)
    key = (st[:, 0] << 42) | (st[:, 1] << 21) | st[:, 2]
    _, first = np.unique(key, return_index=True)
    tris = tris[first]

    p = mb.verts_of(tris.reshape(-1)).reshape(-1, 3, 3)
    sub_area = 0.5 * np.linalg.norm(
        np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]), axis=1).sum()
    # asymmetric certificate: a DEFICIT means a tiling hole (the surface
    # would be partially unconstrained) and fails hard; an EXCESS means a
    # near-coplanar neighbor's sub-faces were double-claimed, which only
    # adds redundant on-surface constraint rows — tolerated (each claim is on-plane inside the footprint; cap 2x for sanity).
    if sub_area < (1.0 - _CERT) * area or sub_area > 2.0 * area:
        raise ConformingError(
            f"face {fi}: sub-face area {sub_area:.12g} != face area {area:.12g}")
    return tris.astype(np.int64)
