"""Tetrahedral background-domain construction (TPU-era mesher).

The reference tet-meshes its bounding cube with TetGen's incremental
constrained Delaunay + quality refinement
(reference src/signed_heat_tet_solver.cpp:885-1241, flags
"pq1.414zfenna<maxvol>" at include/signed_heat_tet_solver.h:96-97), falling
back to a point-cloud-style mesh (cube-constrained only, input vertices as
mesh vertices) for polygon meshes or TetGen failures (:24-33,1018-1094).

This module is a from-scratch re-design rather than a Delaunay port: a
**Kuhn-lattice stuffing mesher**:

1. the bounding cube (centroid +- radius*scale, reference
   buildCubeAroundSurface :1220-1239) is covered by a uniform lattice of
   cubes, each split into 6 Kuhn tetrahedra sharing the main diagonal;
2. each source vertex is inserted *exactly*:
   - **snap**: if its nearest free lattice node is within ``SNAP_ALPHA * h``
     and moving that node inverts no incident tet, the node is moved to the
     source position (quality-preserving, no new tets);
   - **split**: otherwise the containing tet is split 1->4 around the point
     (on-face points split both adjacent tets 1->3 each, on-edge points
     split the full edge ring 1->2 each, coincident points are deduplicated).
3. when source *faces* are supplied, the surface is **recovered** so that it
   becomes an exact union of tet faces (shm3d.tet.conforming): every source
   edge is recovered as a chain of mesh edges by walk-and-split Steiner
   insertion along the segment, then every source face by eliminating mesh
   edges that pierce its interior.  This is the TPU-era equivalent of the
   reference's conforming tetrahedralization (TETFLAGS_PRESERVE at
   signed_heat_tet_solver.cpp:967; surface-face identification :983-1011);
   input faces may be subdivided into coplanar sub-faces, which preserves
   the Crouzeix-Raviart constraint semantics exactly (the same geometric
   surface is pinned).

No exact geometric predicates, no incremental Delaunay; deterministic and
array-based with a small Python driver loop (native C++ version of the same
algorithm in csrc/native/lattice_tet.cpp).  The resulting mesh preserves the
reference's *vertex-index contract*: source vertices occupy indices 0..V-1
(ZeroSet Dirichlet pinning and greedy BFS seeding depend on this,
reference :169-180,417-425,451-458).
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from ..utils import treestore

# Kuhn decomposition of the unit cube: 6 tets around the diagonal c0-c7,
# corner id c = i + 2j + 4k; rows ordered for positive volume.
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
# face opposite corner j of a positively-oriented tet, outward orientation
_OPP = ((1, 2, 3), (0, 3, 2), (0, 1, 3), (0, 2, 1))

SNAP_ALPHA = 0.35  # max snap displacement as a fraction of the lattice cell


def _norm3(v) -> float:
    """sqrt(x^2+y^2+z^2) in C++-matching scalar order (np.linalg.norm on a
    single vector calls BLAS dnrm2, whose scaled algorithm rounds
    differently and breaks native/python bit parity)."""
    x, y, z = float(v[0]), float(v[1]), float(v[2])
    import math

    return math.sqrt(x * x + y * y + z * z)


@dataclasses.dataclass
class TetMesh:
    """Array-based tet mesh with the adjacency the solver needs.

    vertices (NV, 3); tets (NT, 4) positively oriented; faces (NF, 3) global
    unique faces (orientation = first-seen outward); tet_face (NT, 4) global
    face id of the face opposite corner j; tet_face_sign (NT, 4) +1 when the
    stored global orientation is outward for this tet (the reference packs
    this sign into the index, signed_heat_tet_solver.cpp:1278-1301);
    vt_indptr/vt_data: CSR vertex -> incident tets (reference ``vertexTet``
    :1302-1308); n_src: source vertices occupy ids 0..n_src-1; src_vertex
    (V,) maps each input vertex to its mesh vertex (duplicates possible only
    for coincident inputs); n_snapped/n_split: insertion statistics.

    Conforming meshes (surface recovered, reference :885-1016) additionally
    carry: surface_faces (S,) global face ids tiling the source surface;
    surface_parent (S,) input-face index each sub-face belongs to;
    surface_orient (S,) +1 where the stored face orientation's normal agrees
    with the input face normal (reference orientation matching :983-1011).
    """

    vertices: np.ndarray
    tets: np.ndarray
    faces: np.ndarray
    tet_face: np.ndarray
    tet_face_sign: np.ndarray
    vt_indptr: np.ndarray
    vt_data: np.ndarray
    n_src: int
    src_vertex: np.ndarray
    n_snapped: int = 0
    n_split: int = 0
    conforming: bool = False
    surface_faces: Optional[np.ndarray] = None
    surface_parent: Optional[np.ndarray] = None
    surface_orient: Optional[np.ndarray] = None

    @classmethod
    def from_fields(cls, other) -> "TetMesh":
        """The port's TetMesh with the fields of ``other`` read by name (a
        TetMesh of the JAX package, say); the arrays are shared."""
        return cls(**{f.name: getattr(other, f.name) for f in dataclasses.fields(cls)})

    @property
    def n_vertices(self) -> int:
        return int(self.vertices.shape[0])

    @property
    def n_tets(self) -> int:
        return int(self.tets.shape[0])

    @property
    def n_faces(self) -> int:
        return int(self.faces.shape[0])

    def tet_volumes(self) -> np.ndarray:
        v, t = self.vertices, self.tets
        a, b, c, d = v[t[:, 0]], v[t[:, 1]], v[t[:, 2]], v[t[:, 3]]
        return np.einsum("ij,ij->i", np.cross(b - a, c - a), d - a) / 6.0

    def barycenters(self) -> np.ndarray:
        return self.vertices[self.tets].mean(axis=1)

    def face_barycenters(self) -> np.ndarray:
        return self.vertices[self.faces].mean(axis=1)

    def face_areas(self) -> np.ndarray:
        tri = self.vertices[self.faces]
        n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
        return 0.5 * np.linalg.norm(n, axis=1)

    def mean_node_spacing(self) -> float:
        """Mean pairwise distance of the 4 face barycenters per tet
        (reference computeMeanNodeSpacing, signed_heat_tet_solver.cpp:1312-1328)."""
        fb = self.face_barycenters()[self.tet_face]  # (NT, 4, 3)
        acc = 0.0
        for j in range(4):
            for k in range(j + 1, 4):
                acc += np.linalg.norm(fb[:, j] - fb[:, k], axis=1).sum()
        return float(acc / (6 * self.n_tets))

    def validate(self) -> None:
        """Complex sanity: positive volumes; every face incident to <= 2 tets
        with opposite outward orientations (raises AssertionError)."""
        vols = self.tet_volumes()
        assert (vols > 0).all(), f"{int((vols <= 0).sum())} non-positive tets"
        nf = self.n_faces
        cnt = np.zeros(nf, dtype=np.int64)
        sgn = np.zeros(nf, dtype=np.int64)
        np.add.at(cnt, self.tet_face.reshape(-1), 1)
        np.add.at(sgn, self.tet_face.reshape(-1), self.tet_face_sign.reshape(-1))
        assert cnt.max() <= 2, "face shared by >2 tets"
        interior = cnt == 2
        assert (sgn[interior] == 0).all(), "interior face with same-side tets"


# --- compact treestore encoding ------------------------------------------
# Index arrays are int64 in memory but every value fits int32 at any
# realistic mesh size (< 2^31 vertices/tets/faces): storing them int32
# halves ~340 MB of the knot@h=1 artifact.  unpack
# restores int64 so in-memory behavior is identical to a fresh build.

_TETMESH_I64 = ("tets", "faces", "tet_face", "tet_face_sign", "vt_indptr",
                "vt_data", "src_vertex", "surface_faces", "surface_parent",
                "surface_orient")


def _pack_tetmesh(m: "TetMesh") -> dict:
    d = {f.name: getattr(m, f.name) for f in dataclasses.fields(TetMesh)}
    for k in _TETMESH_I64:
        a = d[k]
        if (isinstance(a, np.ndarray) and a.dtype == np.int64
                and (a.size == 0
                     or (a.max() < np.iinfo(np.int32).max
                         and a.min() > np.iinfo(np.int32).min))):
            d[k] = a.astype(np.int32)
    return d


def _unpack_tetmesh(d: dict) -> "TetMesh":
    d = dict(d)
    for k in _TETMESH_I64:
        a = d.get(k)
        if isinstance(a, np.ndarray) and a.dtype == np.int32:
            d[k] = np.asarray(a, np.int64)
    return TetMesh(**d)


treestore.register_packed(TetMesh, _pack_tetmesh, _unpack_tetmesh)


#: bumped whenever the default meshing behavior changes (lattice heuristics,
#: grading, recovery): part of the disk-cache key, so stale artifacts from an
#: older mesher can never shadow the current default discretization.
MESHER_VERSION = 2

#: fine-band cells/axis cap for the graded (octree) lattice.  The graded
#: builder's tet count scales with surface area (~res^2), not volume
#: (~res^3), so its cap sits above the uniform one; measured: knot@96 ->
#: 1.5M tets / 108 s recovery, rocker@96 -> 1.0M / 143 s.
_GRADED_CAP = 128

#: target fine-cell size as a multiple of the source's median edge length.
#: Exact recovery is fastest and most reliable when lattice cells are
#: comparable to the surface triangles (measured minima: bunny certifies
#: down to ratio 2.7 but is 2x faster at 1.7; chair fails at 2.9, passes
#: at 2.1; rocker fails at 2.1, passes at 1.75; knot passes at 1.49).
_SURFACE_CELL_RATIO = 1.6


def _heuristic_cells(half_side: float, mean_area: float, h_coef: float) -> int:
    """Uncapped cells-per-axis.  The reference drives refinement with
    TetGen's max-tet-volume = 2^-hCoef * meanFaceArea
    (signed_heat_tet_solver.cpp:16-23); a Kuhn tet has volume cell^3/6, so
    cell ~ (6 * maxvol)^(1/3)."""
    maxvol = (2.0 ** -h_coef) * mean_area
    cell = (6.0 * maxvol) ** (1.0 / 3.0)
    return int(np.ceil(2.0 * half_side / cell))


def _lattice_resolution(
    half_side: float, mean_area: float, h_coef: float, cap: int = 96
) -> int:
    """Capped cells per axis for the uniform lattice.

    ``cap`` bounds the uniform lattice (resolution beyond it produces
    multi-million-tet meshes); a warning is emitted when the cap truncates
    the requested refinement so hCoef saturation is visible (the reference
    honors TetGen maxvol unboundedly)."""
    n = _heuristic_cells(half_side, mean_area, h_coef)
    if n > cap:
        warnings.warn(
            f"tet lattice resolution {n} exceeds the cap {cap}; hCoef-driven "
            f"refinement saturates (pass resolution=/lattice_cap= to raise it)",
            stacklevel=2,
        )
    return int(np.clip(n, 8, cap))


def _median_edge_length(src_points: np.ndarray, src_faces: np.ndarray) -> float:
    p = src_points
    f = src_faces
    e = np.concatenate([
        np.linalg.norm(p[f[:, 0]] - p[f[:, 1]], axis=1),
        np.linalg.norm(p[f[:, 1]] - p[f[:, 2]], axis=1),
        np.linalg.norm(p[f[:, 2]] - p[f[:, 0]], axis=1),
    ])
    e = e[e > 0]
    return float(np.median(e)) if e.size else 0.0


def _graded_resolution(half_side: float, mean_area: float, h_coef: float,
                       src_points: np.ndarray, src_faces: np.ndarray,
                       cap: int = _GRADED_CAP) -> int:
    """Fine-band cells per axis for the graded conforming build.

    Two lower bounds, take the max, then cap:
    - the reference's maxvol heuristic (hCoef semantics: +1 halves maxvol,
      refining the band by 2^(1/3); the far field grades coarser either
      way — a documented deviation from TetGen's globally-uniform maxvol,
      which at these domain sizes implies tens of millions of tets);
    - the surface-resolving floor cell <= ratio * median source edge:
      coarser lattices under-resolve the features and Steiner recovery
      blows up or leaves certificate holes (it is also SLOWER: bunny@16
      fails at 100 s where bunny@40 certifies in 13 s)."""
    n_vol = _heuristic_cells(half_side, mean_area, h_coef)
    med = _median_edge_length(src_points, src_faces)
    n_surf = (int(np.ceil(2.0 * half_side / (_SURFACE_CELL_RATIO * med)))
              if med > 0 else 8)
    n = max(n_vol, n_surf)
    if n > cap:
        warnings.warn(
            f"graded tet resolution {n} exceeds the cap {cap}; refinement "
            f"saturates (pass resolution=/lattice_cap= to raise it)",
            stacklevel=2,
        )
    # the graded builder tiles leaf blocks of up to 8 cells: round to the
    # NEAREST multiple of 8 (round-up doubles tiny fixture meshes, 9 -> 16,
    # which blows up CI solve times; all reference scans certify at their
    # nearest-rounded resolution)
    n = int(np.clip(n, 8, cap))
    return max(8, ((n + 4) // 8) * 8)


class ConformingError(RuntimeError):
    """Surface recovery failed; callers fall back to the non-conforming
    (vertex-path) mesh, mirroring the reference's TetGen-failure fallback
    (signed_heat_tet_solver.cpp:966-977,24-33)."""


class _MeshBuilder:
    """Base Kuhn lattice as one NumPy array + copy-on-write cells for splits.

    The base lattice (ncells * 6 tets) is a single int64 array; snapping only
    moves vertex positions.  Split insertion materializes per-cell buckets
    lazily: replaced base tets are flagged dead, children live in a growing
    ``extra`` tet array indexed through ``cell_extra``.  ``constrained``
    marks vertices that lie exactly on a source constraint (vertex, edge or
    face); only unconstrained vertices may be moved by recovery snapping."""

    def __init__(self, nodes: np.ndarray, nl: int, npts: int, bmin, h: float):
        self.nl, self.npts, self.bmin, self.h = nl, npts, np.asarray(bmin), h
        self.positions = nodes.copy()          # (n_nodes, 3), mutated by snaps
        self._n0 = nodes.shape[0]
        self._ev = np.empty((256, 3), dtype=np.float64)   # extra verts (grow)
        self._nev = 0

        dx, dy, dz = 1, npts, npts * npts
        corner_off = np.array([0, dx, dy, dx + dy, dz, dx + dz, dy + dz, dx + dy + dz])
        ci = np.arange(nl)
        CK, CJ, CI = np.meshgrid(ci, ci, ci, indexing="ij")
        c000 = (CI + CJ * npts + CK * npts * npts).reshape(-1)
        corners = c000[:, None] + corner_off[None, :]          # (ncells, 8)
        self.base_tets = corners[:, _KUHN_TETS].reshape(-1, 4)  # cell c -> tets 6c..6c+5
        self.base_dead = np.zeros(self.base_tets.shape[0], dtype=bool)
        self._et = np.empty((1024, 4), dtype=np.int64)    # extra tets (grow)
        self._et_dead = np.zeros(1024, dtype=bool)
        self._net = 0
        self.cell_extra: Dict[int, List[int]] = {}
        self.constrained: Set[int] = set()
        # lex cell index (i, j, k) -> i + j*nl + k*nl^2; base tets of cell lex
        # occupy rows 6*lex..6*lex+5 by construction

    # -- vertices

    def n_verts(self) -> int:
        return self._n0 + self._nev

    def vert(self, vid: int) -> np.ndarray:
        return self.positions[vid] if vid < self._n0 else self._ev[vid - self._n0]

    def verts_of(self, ids: np.ndarray) -> np.ndarray:
        ids = np.asarray(ids, dtype=np.int64)
        out = np.empty(ids.shape + (3,), dtype=np.float64)
        m = ids < self._n0
        out[m] = self.positions[ids[m]]
        out[~m] = self._ev[ids[~m] - self._n0]
        return out

    def add_vert(self, p: np.ndarray) -> int:
        if self._nev == self._ev.shape[0]:
            self._ev = np.concatenate([self._ev, np.empty_like(self._ev)], axis=0)
        self._ev[self._nev] = np.asarray(p, dtype=np.float64)
        self._nev += 1
        return self._n0 + self._nev - 1

    def _set_vert(self, vid: int, p: np.ndarray) -> None:
        if vid < self._n0:
            self.positions[vid] = p
        else:
            self._ev[vid - self._n0] = p

    # -- cells

    def cell_of(self, p: np.ndarray) -> Tuple[int, int, int]:
        ijk = np.floor((p - self.bmin) / self.h).astype(np.int64)
        return tuple(int(x) for x in np.clip(ijk, 0, self.nl - 1))

    def cell_lex(self, i, j, k) -> int:
        return i + j * self.nl + k * self.nl * self.nl

    def live_tets_in_cells(self, irange, jrange, krange) -> List[int]:
        """Live tet ids over a cell box (base ids < 6*ncells, extras offset,
        deduplicated — snaps may double-bucket extra tets)."""
        out: List[int] = []
        nbase = self.base_tets.shape[0]
        seen_extra: Set[int] = set()
        for k in krange:
            for j in jrange:
                for i in irange:
                    lex = self.cell_lex(i, j, k)
                    for t in range(6 * lex, 6 * lex + 6):
                        if not self.base_dead[t]:
                            out.append(t)
                    for e in self.cell_extra.get(lex, ()):
                        if not self._et_dead[e] and e not in seen_extra:
                            seen_extra.add(e)
                            out.append(nbase + e)
        return out

    def nearby_tets(self, p: np.ndarray, rings: int = 1) -> List[int]:
        ci, cj, ck = self.cell_of(p)
        lo = lambda c: max(c - rings, 0)
        hi = lambda c: min(c + rings, self.nl - 1) + 1
        return self.live_tets_in_cells(
            range(lo(ci), hi(ci)), range(lo(cj), hi(cj)), range(lo(ck), hi(ck))
        )

    # -- tets

    def tet_verts(self, tid: int) -> Tuple[int, int, int, int]:
        nbase = self.base_tets.shape[0]
        if tid < nbase:
            return tuple(int(v) for v in self.base_tets[tid])
        return tuple(int(v) for v in self._et[tid - nbase])

    def tets_of(self, tids) -> np.ndarray:
        tids = np.asarray(tids, dtype=np.int64)
        nbase = self.base_tets.shape[0]
        out = np.empty((tids.shape[0], 4), dtype=np.int64)
        m = tids < nbase
        out[m] = self.base_tets[tids[m]]
        out[~m] = self._et[tids[~m] - nbase]
        return out

    def vert_tets(self, vid: int) -> List[int]:
        """All live tets incident to vertex vid (cell-local search; any
        vertex's star lies within one ring of its position's cell)."""
        p = self.vert(vid)
        return [t for t in self.nearby_tets(p, rings=1) if vid in self.tet_verts(t)]

    def edge_exists(self, u: int, v: int) -> bool:
        for tid in self.vert_tets(u):
            if v in self.tet_verts(tid):
                return True
        return False

    def _bary(self, tid: int, p: np.ndarray) -> np.ndarray:
        # Cramer's rule in scalar arithmetic, operation-order-identical to
        # the C++ core (csrc/native/lattice_tet.cpp Builder::bary) so both
        # implementations make bit-identical location/classification choices
        # (BLAS-backed np.dot rounds differently and flips ties)
        va, vb, vc, vd = (self.vert(v) for v in self.tet_verts(tid))
        ax, ay, az = float(va[0]), float(va[1]), float(va[2])
        ux, uy, uz = float(vb[0]) - ax, float(vb[1]) - ay, float(vb[2]) - az
        vx, vy, vz = float(vc[0]) - ax, float(vc[1]) - ay, float(vc[2]) - az
        wx, wy, wz = float(vd[0]) - ax, float(vd[1]) - ay, float(vd[2]) - az
        rx, ry, rz = float(p[0]) - ax, float(p[1]) - ay, float(p[2]) - az
        cx, cy, cz = vy * wz - vz * wy, vz * wx - vx * wz, vx * wy - vy * wx
        det = ux * cx + uy * cy + uz * cz
        if abs(det) < 1e-300:
            return np.array([-1.0, -1, -1, -1])
        b1 = (rx * cx + ry * cy + rz * cz) / det
        c2x, c2y, c2z = ry * wz - rz * wy, rz * wx - rx * wz, rx * wy - ry * wx
        b2 = (ux * c2x + uy * c2y + uz * c2z) / det
        c3x, c3y, c3z = vy * rz - vz * ry, vz * rx - vx * rz, vx * ry - vy * rx
        b3 = (ux * c3x + uy * c3y + uz * c3z) / det
        return np.array([1.0 - b1 - b2 - b3, b1, b2, b3])

    def _replace(self, tid: int, new_tets) -> None:
        nbase = self.base_tets.shape[0]
        if tid < nbase:
            self.base_dead[tid] = True
        else:
            self._et_dead[tid - nbase] = True
        for nt in new_tets:
            if self._net == self._et.shape[0]:
                self._et = np.concatenate([self._et, np.empty_like(self._et)], axis=0)
                self._et_dead = np.concatenate(
                    [self._et_dead, np.zeros_like(self._et_dead)], axis=0)
            eid = self._net
            self._et[eid] = nt
            self._et_dead[eid] = False
            self._net += 1
            va, vb, vc, vd = (self.vert(int(v)) for v in nt)
            bary = (va + vb + vc + vd) * 0.25  # C++-matching arithmetic order
            ci, cj, ck = self.cell_of(bary)
            self.cell_extra.setdefault(self.cell_lex(ci, cj, ck), []).append(eid)

    def _try_move(self, vid: int, p: np.ndarray) -> bool:
        """Move vertex vid to p if no incident tet degenerates (recovery
        snapping, the isosurface-stuffing-style warp that avoids slivers)."""
        inc = self.vert_tets(vid)
        if not inc:
            return False
        old = self.vert(vid).copy()
        self._set_vert(vid, p)
        floor = 1e-12 * self.h ** 3
        for tid in inc:
            t = self.tet_verts(tid)
            va, vb, vc, vd = (self.vert(v) for v in t)
            ux, uy, uz = vb[0] - va[0], vb[1] - va[1], vb[2] - va[2]
            vx, vy, vz = vc[0] - va[0], vc[1] - va[1], vc[2] - va[2]
            wx, wy, wz = vd[0] - va[0], vd[1] - va[1], vd[2] - va[2]
            vol = ((uy * vz - uz * vy) * wx + (uz * vx - ux * vz) * wy
                   + (ux * vy - uy * vx) * wz) / 6.0
            if vol <= floor:
                self._set_vert(vid, old)
                return False
        # re-bucket extra tets whose barycenter cell may have shifted
        nbase = self.base_tets.shape[0]
        for tid in inc:
            if tid >= nbase:
                eid = tid - nbase
                va, vb, vc, vd = (self.vert(v) for v in self.tet_verts(tid))
                bary = (va + vb + vc + vd) * 0.25
                lex = self.cell_lex(*self.cell_of(bary))
                lst = self.cell_extra.setdefault(lex, [])
                if eid not in lst:
                    lst.append(eid)
        return True

    def weld_vertex_face(self, cur: int, tid: int) -> bool:
        """Vertex-face weld: tet ``tid`` has vertex ``cur`` lying almost on
        its opposite face f (a minimal pancake that blocks edge walks).
        Remove the pancake and re-tetrahedralize its neighbor across f into
        3 tets through cur (the 2-3-flip family): the union (bipyramid over
        f with apexes cur and the neighbor's apex) is exactly retiled.
        Refuses when a child would be degenerate.  Destroying faces is safe
        here: welds run only during edge recovery (before any face tiling
        exists), and a weld never removes a mesh EDGE — every edge of the
        two dead tets survives in the replacement children — so recovered
        chains are preserved."""
        t = self.tet_verts(tid)
        if cur not in t:
            return False
        f = [v for v in t if v != cur]
        fset = set(f)
        neighbor = -1
        for other in self.nearby_tets(self.vert(cur), rings=1):
            if other != tid and fset.issubset(self.tet_verts(other)):
                neighbor = other
                break
        if neighbor < 0:
            return False
        to = self.tet_verts(neighbor)
        children = []
        for j in range(4):
            if to[j] in fset:
                nt = list(to)
                nt[j] = cur
                children.append(tuple(nt))
        tiny = 1e-11 * self.h ** 3
        q = self.vert(cur)
        new_sum = 0.0
        for ch in children:
            v = self._child_vol(tuple(-1 if x == cur else x for x in ch), q)
            if v <= tiny:
                return False
            new_sum += v
        old_sum = (self._child_vol(t, q) + self._child_vol(self.tet_verts(neighbor), q))
        # volume conservation: a folded retiling double-counts volume
        if abs(new_sum - old_sum) > 1e-9 * old_sum + tiny:
            return False
        self._replace(tid, [])
        self._replace(neighbor, children)
        return True

    def collapse_into(self, w: int, keep: int) -> bool:
        """Edge collapse: merge unconstrained vertex w into keep (standard
        micro-feature removal).  Tets containing both vanish; the rest of
        w's star is rewritten with w -> keep.  Refuses on constrained w or
        any resulting degenerate/inverted tet."""
        if w in self.constrained or w == keep:
            return False
        star = self.vert_tets(w)
        if not star:
            return False
        tiny = 1e-11 * self.h ** 3
        q = self.vert(keep)
        plans = []
        old_sum = 0.0
        new_sum = 0.0
        for tid in star:
            t = self.tet_verts(tid)
            old_sum += self._child_vol(t, q)
            if keep in t:
                plans.append((tid, None))  # collapses away
                continue
            nt = tuple(keep if x == w else x for x in t)
            probe = tuple(-1 if x == keep else x for x in nt)
            v = self._child_vol(probe, q)
            if v <= tiny:
                return False
            new_sum += v
            plans.append((tid, nt))
        # volume conservation: a folded star double-counts volume
        if abs(new_sum - old_sum) > 1e-9 * old_sum + tiny:
            return False
        for tid, nt in plans:
            self._replace(tid, [] if nt is None else [nt])
        return True

    def insert_point(self, p: np.ndarray, eps: float, snap_tol: float = 0.0,
                     dedup_tol: Optional[float] = None, project: bool = False,
                     ) -> Tuple[int, str]:
        """Insert p as a mesh vertex; returns (vertex id, how).
        With snap_tol > 0, an unconstrained mesh vertex within snap_tol of p
        is moved onto p instead of splitting (sliver avoidance).  With
        project=True, a point classified on a face/edge is projected exactly
        onto that feature's plane/line before splitting — a split through a
        point epsilon OFF its feature creates inverted/degenerate children
        that corrupt the complex; projection moves the point by at most
        ~eps * cell, which the recovery tolerance ladder absorbs."""
        # locate: widen the search while the best candidate is not clearly
        # interior — a point on a cell boundary can sit in a tet bucketed in
        # a neighboring cell, and a mislocated insert corrupts the complex
        best_tid, best_bary, best_min = -1, None, -np.inf
        for rings in (0, 1, 2):
            for tid in self.nearby_tets(p, rings=rings):
                bary = self._bary(tid, p)
                mn = bary.min()
                if mn > best_min:
                    best_tid, best_bary, best_min = tid, bary, mn
                if mn > eps:
                    break
            if best_min > -eps:
                break
        if best_tid < 0 or best_min < -1e-5:
            raise RuntimeError(
                f"point location failed (best min-bary {best_min:.3e})")
        tid, bary = best_tid, best_bary
        tet = self.tet_verts(tid)

        # dedup by actual distance (barycentrics are unreliable in slivers)
        if dedup_tol is None:
            dedup_tol = 1e-12 * self.h + 1e-12
        vdist = [_norm3(self.vert(v) - p) for v in tet]
        jmin = int(np.argmin(vdist))
        if vdist[jmin] <= dedup_tol:
            return tet[jmin], "dedup"

        if snap_tol > 0.0:
            for j in np.argsort(vdist, kind="stable"):
                if vdist[j] > snap_tol:
                    break
                w = tet[int(j)]
                if w in self.constrained:
                    continue
                if self._try_move(w, p):
                    return w, "snap"

        # classify by ABSOLUTE distance to the located tet's face planes:
        # barycentric classification scales with the tet's shape, so inside
        # slivers it misjudges distances by orders of magnitude and lets
        # children collapse; absolute distances lower-bound every new
        # child's height by d_tol
        d_tol = eps * self.h
        dists = [self._face_plane_dist(tet, j, p) for j in range(4)]
        order_d = sorted(range(4), key=lambda j: dists[j])
        n_zero = min(sum(1 for d in dists if d <= d_tol), 2)

        # try zero-set sizes in order: the natural classification first,
        # then the alternatives (both finer and coarser) — committing the
        # first split plan whose children all clear the volume floor.  A
        # split through a point epsilon OFF its feature creates inverted or
        # collapsed children that corrupt every later operation nearby; the
        # floor is RELATIVE to each parent (thin-but-valid parents may
        # legally split into proportionally thin children), with a tiny
        # absolute backstop.
        tiny = 1e-11 * self.h ** 3  # above the double-precision volume noise
        sizes = [n_zero] + [k for k in (2, 1, 0) if k != n_zero]
        for k in sizes:
            zero = sorted(order_d[:k])
            q = self._feature_point(p, tet, zero, project)
            plan, how = self._split_plan(tid, tet, zero, q)

            def _ok(st, chs):
                floor = max(1e-9 * self._child_vol(self.tet_verts(st), q), tiny)
                return all(self._child_vol(ch, q) > floor for ch in chs)

            if plan is not None and all(_ok(st, chs) for st, chs in plan):
                pid = self.add_vert(q)
                for st, chs in plan:
                    self._replace(st, [[pid if x == -1 else x for x in ch]
                                       for ch in chs])
                return pid, how
        # no floor-valid split: dedup ONLY if the nearest vertex is within
        # the tolerance scale (gluing a point to a vertex a cell away would
        # destroy the constraint geometry); otherwise force-commit the
        # natural plan — thin children are less harmful than displacement,
        # and recovery failure degrades gracefully
        if vdist[jmin] <= 10.0 * d_tol:
            return tet[jmin], "dedup"
        zero = sorted(order_d[:n_zero])
        q = self._feature_point(p, tet, zero, project)
        plan, how = self._split_plan(tid, tet, zero, q)
        if plan is None:
            return tet[jmin], "dedup"
        pid = self.add_vert(q)
        for st, chs in plan:
            self._replace(st, [[pid if x == -1 else x for x in ch] for ch in chs])
        return pid, how

    def _face_plane_dist(self, tet, jz: int, p) -> float:
        """Distance from p to the plane of the face opposite corner jz
        (0 for degenerate faces: treat as on-plane)."""
        A, B, C = (self.vert(tet[j]) for j in range(4) if j != jz)
        n = np.cross(B - A, C - A)
        nn = _norm3(n)
        if nn <= 1e-300:
            return 0.0
        return abs(float(n[0] * (p[0] - A[0]) + n[1] * (p[1] - A[1])
                         + n[2] * (p[2] - A[2]))) / nn

    def _feature_point(self, p, tet, zero, project):
        """p projected onto the feature implied by the zero set (plane of the
        face opposite zero[0] / line of the two live corners)."""
        if not project or len(zero) == 0:
            return p
        if len(zero) == 1:
            A, B, C = (self.vert(tet[j]) for j in range(4) if j != zero[0])
            n = np.cross(B - A, C - A)
            denom = float(n[0] * n[0] + n[1] * n[1] + n[2] * n[2])
            if denom <= 0.0:
                return p
            k = float(n[0] * (p[0] - A[0]) + n[1] * (p[1] - A[1])
                      + n[2] * (p[2] - A[2])) / denom
            return p - n * k
        lu, lv = (tet[j] for j in range(4) if j not in zero)
        U, V = self.vert(lu), self.vert(lv)
        d = V - U
        dd = float(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
        if dd <= 0.0:
            return p
        t = float(d[0] * (p[0] - U[0]) + d[1] * (p[1] - U[1])
                  + d[2] * (p[2] - U[2])) / dd
        return U + d * t

    def _split_plan(self, tid, tet, zero, q):
        """List of (tet id to replace, child tuples with -1 = the new vertex)
        for the classified split, or (None, "") when no plan exists."""
        if len(zero) == 0:  # interior: 1 -> 4
            a, b, c, d = tet
            return [(tid, [(-1, b, c, d), (a, -1, c, d), (a, b, -1, d), (a, b, c, -1)])], "split4"
        if len(zero) == 1:  # on the face opposite corner zero[0]
            jz = zero[0]
            fset = set(tet[j] for j in range(4) if j != jz)
            split_tids = [tid]
            for other in self.nearby_tets(q, rings=1):
                if other != tid and fset.issubset(self.tet_verts(other)):
                    split_tids.append(other)
                    break
            plan = []
            for st in split_tids:
                t = self.tet_verts(st)
                chs = []
                for j in range(4):
                    if t[j] in fset:
                        nt = list(t)
                        nt[j] = -1
                        chs.append(tuple(nt))
                plan.append((st, chs))
            return plan, "splitface"
        if len(zero) == 2:  # on the edge between the two live corners
            u, v = (tet[j] for j in range(4) if j not in zero)
            ring = [t for t in self.nearby_tets(q, rings=1)
                    if u in self.tet_verts(t) and v in self.tet_verts(t)]
            if not ring:
                return None, ""
            plan = []
            for st in ring:
                t = list(self.tet_verts(st))
                t1 = tuple(-1 if x == v else x for x in t)
                t2 = tuple(-1 if x == u else x for x in t)
                plan.append((st, [t1, t2]))
            return plan, "splitedge"
        return None, ""

    def _child_vol(self, child, q) -> float:
        va, vb, vc, vd = (q if x == -1 else self.vert(x) for x in child)
        ux, uy, uz = vb[0] - va[0], vb[1] - va[1], vb[2] - va[2]
        vx, vy, vz = vc[0] - va[0], vc[1] - va[1], vc[2] - va[2]
        wx, wy, wz = vd[0] - va[0], vd[1] - va[1], vd[2] - va[2]
        return ((uy * vz - uz * vy) * wx + (uz * vx - ux * vz) * wy
                + (ux * vy - uy * vx) * wz) / 6.0


def build_tet_domain(
    src_points: np.ndarray,
    scale: float = 2.0,
    h_coef: float = 0.0,
    mean_area: Optional[float] = None,
    resolution: Optional[int] = None,
    lattice_cap: int = 96,
    src_faces: Optional[np.ndarray] = None,
) -> TetMesh:
    """Kuhn-lattice stuffing mesh of the bounding cube containing
    ``src_points`` (V, 3) exactly as mesh vertices 0..V-1.

    With ``src_faces`` (F, 3) given, the surface is additionally recovered so
    every input triangle is an exact union of tet faces (``conforming=True``,
    the reference's default domain for triangle meshes,
    signed_heat_tet_solver.cpp:885-1016).  Recovery failure falls back to the
    non-conforming mesh with a warning (reference fallback :24-33)."""
    src_points = np.asarray(src_points, dtype=np.float64)
    V = src_points.shape[0]
    c = src_points.mean(axis=0)
    radius = np.linalg.norm(src_points - c, axis=1).max()
    if radius <= 0.0:
        radius = 1.0  # degenerate input (single point / coincident points)
    s = radius * scale

    from . import native as native_mod

    # the graded (octree) lattice is the default for conforming builds when
    # the native exact builder is present; SHM3D_GRADED=0 restores the
    # uniform lattice
    graded = (src_faces is not None and native_mod.conforming_available()
              and os.environ.get("SHM3D_GRADED", "") != "0")
    if resolution is None:
        if mean_area is None:
            mean_area = (2.0 * s / 16.0) ** 2
        if graded:
            resolution = _graded_resolution(
                s, mean_area, h_coef, src_points,
                np.asarray(src_faces, np.int64),
                cap=max(lattice_cap, _GRADED_CAP))
        else:
            resolution = _lattice_resolution(s, mean_area, h_coef,
                                             cap=lattice_cap)
    nl = int(resolution)

    if src_faces is None and native_mod.available():
        out = native_mod.lattice_build(src_points, c, s, nl)
        if out is not None:
            verts, tets, vertex_of, n_snapped, n_split = out
            return _finalize_arrays(verts, tets, vertex_of, n_snapped, n_split)

    if src_faces is not None and native_mod.conforming_available():
        # Recoverability is resolution-dependent: a lattice that
        # under-resolves the surface features makes Steiner recovery blow up
        # or leave certificate holes, while finer lattices certify faster
        # (measured: bunny fails at 16, certifies at 24 in 26 s and at 40 in
        # 13 s; rocker fails at 80, certifies at 96).  The surface-aware
        # heuristic usually lands first try; on certificate failure retry
        # ~25% finer, then at the cap.  The fallback mesh stays at the
        # HEURISTIC resolution (the reference's fallback semantics,
        # signed_heat_tet_solver.cpp:24-33).
        n_retries = int(os.environ.get("SHM3D_RECOVERY_RETRIES", "2"))
        cap = max(lattice_cap, _GRADED_CAP) if graded else lattice_cap
        bump = int(np.ceil(nl * 1.25 / 8.0)) * 8 if graded else int(np.ceil(nl * 1.5))
        attempts = [nl]
        if n_retries >= 1 and bump < cap:
            attempts.append(bump)
        if n_retries >= 1 and cap > nl:
            attempts.append(cap)
        attempts = sorted(set(attempts))[: 1 + max(0, n_retries)]
        base_out = None
        for nl_i in attempts:
            out = native_mod.conforming_build(
                src_points, np.asarray(src_faces, np.int64), c, s, nl_i)
            if out is None:
                break
            verts, tets, vertex_of, n_snapped, n_split, tris, parents = out
            if tris is not None:
                if nl_i != nl:
                    warnings.warn(
                        f"conforming recovery succeeded at retry resolution "
                        f"{nl_i} (heuristic {nl} left certificate holes)",
                        stacklevel=2)
                return _finalize_arrays(verts, tets, vertex_of, n_snapped, n_split,
                                        surface_tris=tris, surface_parent=parents,
                                        src_points=src_points, src_faces=src_faces)
            if base_out is None:
                base_out = out
        if base_out is not None:
            verts, tets, vertex_of, n_snapped, n_split, tris, parents = base_out
            warnings.warn(
                f"conforming surface recovery failed (native) at resolutions "
                f"{attempts}; using the non-conforming vertex-path mesh",
                stacklevel=2)
            return _finalize_arrays(verts, tets, vertex_of, n_snapped, n_split)

    mb, vertex_of, n_snapped, n_split = _python_build(
        src_points, c, s, nl, conforming=src_faces is not None)

    surface_tris = surface_parent = None
    if src_faces is not None:
        from . import conforming

        try:
            surface_tris, surface_parent = conforming.recover_surface(
                mb, vertex_of, src_points, np.asarray(src_faces, dtype=np.int64))
        except ConformingError as e:
            warnings.warn(
                f"conforming surface recovery failed ({e}); using the "
                f"non-conforming vertex-path mesh (reference fallback "
                f"signed_heat_tet_solver.cpp:24-33)", stacklevel=2)
            surface_tris = surface_parent = None

    return _finalize(mb, vertex_of, n_snapped, n_split,
                     surface_tris=surface_tris, surface_parent=surface_parent,
                     src_points=src_points, src_faces=src_faces)


def _python_build(src_points: np.ndarray, c: np.ndarray, s: float, nl: int,
                  conforming: bool = False):
    """Lattice + source-vertex insertion (NumPy implementation).

    With ``conforming=True`` the split insertion applies the recovery
    tolerance ladder: tet-corner snapping first (position kept exact), then
    feature classification at ~1e-5 cell with projection — a source vertex
    may be displaced by up to ~1e-5 cell onto a lattice face/edge, which
    prevents sub-ladder pancake tets from seeding the recovery (TetGen
    merges nearby points with a tolerance for the same reason).  The
    non-conforming path keeps positions bit-exact."""
    V = src_points.shape[0]
    h = 2.0 * s / nl
    bmin = c - s
    npts = nl + 1
    r = np.arange(npts) * h
    K, J, I = np.meshgrid(r, r, r, indexing="ij")
    nodes = np.stack([I, J, K], axis=-1).reshape(-1, 3) + bmin

    mb = _MeshBuilder(nodes, nl, npts, bmin, h)
    eps = 1e-9

    # --- pass 1 (vectorized): snap source vertices to near free lattice nodes
    base = np.clip(np.rint((src_points - bmin) / h).astype(np.int64), 0, npts - 1)
    nearest = base[:, 0] + base[:, 1] * npts + base[:, 2] * npts * npts
    dist = np.linalg.norm(src_points - nodes[nearest], axis=1)
    claimed: Dict[int, int] = {}
    vertex_of = np.full(V, -1, dtype=np.int64)
    snap_order = np.argsort(dist, kind="stable")  # closest claims first
    snapped_nodes = []
    snapped_srcs = []
    for vi in snap_order:
        nid = int(nearest[vi])
        if dist[vi] > SNAP_ALPHA * h or nid in claimed:
            continue
        claimed[nid] = int(vi)
        snapped_nodes.append(nid)
        snapped_srcs.append(int(vi))
    snapped_nodes = np.asarray(snapped_nodes, dtype=np.int64)
    snapped_srcs = np.asarray(snapped_srcs, dtype=np.int64)
    mb.positions[snapped_nodes] = src_points[snapped_srcs]

    # revert snaps that invert any incident tet (vectorized rounds)
    is_snapped = np.zeros(npts ** 3, dtype=bool)
    is_snapped[snapped_nodes] = True
    for _ in range(6):
        if snapped_nodes.size == 0:
            break
        pos = mb.positions
        T = mb.base_tets
        touched = is_snapped[T].any(axis=1)
        Tt = T[touched]
        a, b2, c2, d2 = pos[Tt[:, 0]], pos[Tt[:, 1]], pos[Tt[:, 2]], pos[Tt[:, 3]]
        vol = np.einsum("ij,ij->i", np.cross(b2 - a, c2 - a), d2 - a) / 6.0
        bad = vol <= 1e-12 * h ** 3  # also revert snaps leaving degenerates
        if not bad.any():
            break
        bad_nodes = np.unique(Tt[bad])
        revert = bad_nodes[is_snapped[bad_nodes]]
        mb.positions[revert] = nodes[revert]
        is_snapped[revert] = False
    kept = is_snapped[snapped_nodes]
    for nid, vi in zip(snapped_nodes[~kept], snapped_srcs[~kept]):
        del claimed[int(nid)]
    vertex_of[snapped_srcs[kept]] = snapped_nodes[kept]
    n_snapped = int(kept.sum())
    # constrain snapped sources NOW: later pass-2 snaps must never move them
    mb.constrained.update(int(n) for n in snapped_nodes[kept])

    # --- pass 2: split-insert the rest
    n_split = 0
    for vi in range(V):
        if vertex_of[vi] >= 0:
            continue
        if conforming:
            pid, how = mb.insert_point(src_points[vi], 1e-5,
                                       snap_tol=SNAP_ALPHA * h, project=True)
        else:
            pid, how = mb.insert_point(src_points[vi], eps)
        vertex_of[vi] = pid
        mb.constrained.add(int(pid))  # immediately: never snap-move a source
        if how not in ("dedup", "snap"):
            n_split += 1

    mb.constrained.update(int(v) for v in vertex_of)
    return mb, vertex_of, n_snapped, n_split


def _finalize(mb: _MeshBuilder, vertex_of: np.ndarray, n_snapped: int, n_split: int,
              surface_tris=None, surface_parent=None,
              src_points=None, src_faces=None) -> TetMesh:
    if mb._nev:
        verts = np.concatenate([mb.positions, mb._ev[:mb._nev]], axis=0)
    else:
        verts = mb.positions
    parts = [mb.base_tets[~mb.base_dead]]
    if mb._net:
        extra = mb._et[:mb._net]
        alive = ~mb._et_dead[:mb._net]
        parts.append(extra[alive])
    tets = np.concatenate(parts, axis=0)
    return _finalize_arrays(verts, tets, vertex_of, n_snapped, n_split,
                            surface_tris=surface_tris, surface_parent=surface_parent,
                            src_points=src_points, src_faces=src_faces)


def _finalize_arrays(verts: np.ndarray, tets: np.ndarray, vertex_of: np.ndarray,
                     n_snapped: int, n_split: int,
                     surface_tris=None, surface_parent=None,
                     src_points=None, src_faces=None) -> TetMesh:
    # reorder: source vertices first, in input order (dedup -> first owner)
    NVold = verts.shape[0]
    order_src, seen = [], set()
    for nid in vertex_of:
        if int(nid) not in seen:
            seen.add(int(nid))
            order_src.append(int(nid))
    order_src = np.asarray(order_src, dtype=np.int64)
    is_src = np.zeros(NVold, dtype=bool)
    is_src[order_src] = True
    new_order = np.concatenate([order_src, np.nonzero(~is_src)[0]])
    remap = np.empty(NVold, dtype=np.int64)
    remap[new_order] = np.arange(NVold)
    verts = verts[new_order]
    tets = remap[tets]
    src_vertex = remap[vertex_of]

    # enforce positive orientation
    a, b, c, d = verts[tets[:, 0]], verts[tets[:, 1]], verts[tets[:, 2]], verts[tets[:, 3]]
    vol = np.einsum("ij,ij->i", np.cross(b - a, c - a), d - a) / 6.0
    neg = vol < 0
    tets[neg, 2], tets[neg, 3] = tets[neg, 3], tets[neg, 2].copy()

    # faces + signed adjacency (packed-int64 keys: NV < 2^21 always holds
    # for <= 96^3 lattices + splits, so three 21-bit ids fit one int64)
    opp = np.stack([tets[:, list(o)] for o in _OPP], axis=1)  # (NT, 4, 3) outward
    flat = opp.reshape(-1, 3)
    f0, f1, f2 = flat[:, 0], flat[:, 1], flat[:, 2]
    lo = np.minimum(np.minimum(f0, f1), f2)
    hi = np.maximum(np.maximum(f0, f1), f2)
    mid = f0 + f1 + f2 - lo - hi
    assert verts.shape[0] < (1 << 21), "face key packing requires NV < 2^21"
    key = (lo << 42) | (mid << 21) | hi
    order_k = np.argsort(key, kind="stable")
    sk = key[order_k]
    newgrp = np.ones(sk.shape[0], dtype=bool)
    newgrp[1:] = sk[1:] != sk[:-1]
    gid_sorted = np.cumsum(newgrp) - 1
    inv = np.empty_like(gid_sorted)
    inv[order_k] = gid_sorted
    first_idx = order_k[newgrp]
    faces = flat[first_idx]
    tet_face = inv.reshape(-1, 4)
    gface = faces[tet_face.reshape(-1)]
    same = _same_orientation(flat, gface)
    tet_face_sign = np.where(same, 1, -1).reshape(-1, 4).astype(np.int8)

    # conforming-surface mapping: sub-face triples -> global face ids + signs
    surface_faces = surface_orient = None
    conforming = False
    if surface_tris is not None and len(surface_tris):
        st = remap[np.asarray(surface_tris, dtype=np.int64)]
        s0, s1, s2 = st[:, 0], st[:, 1], st[:, 2]
        slo = np.minimum(np.minimum(s0, s1), s2)
        shi = np.maximum(np.maximum(s0, s1), s2)
        smid = s0 + s1 + s2 - slo - shi
        want = (slo << 42) | (smid << 21) | shi
        ukeys = sk[newgrp]  # sorted unique keys; position == global face id
        pos = np.searchsorted(ukeys, want)
        ok = (pos < ukeys.shape[0]) & (ukeys[np.minimum(pos, ukeys.shape[0] - 1)] == want)
        if ok.all():
            surface_faces = pos.astype(np.int64)
            surface_parent = np.asarray(surface_parent, dtype=np.int64)
            # orientation: stored face normal vs input face normal
            # (reference surface-face orientation matching :983-1011)
            tri = verts[faces[surface_faces]]
            n_sub = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
            sp = np.asarray(src_points, dtype=np.float64)
            sf = np.asarray(src_faces, dtype=np.int64)[surface_parent]
            n_par = np.cross(sp[sf[:, 1]] - sp[sf[:, 0]], sp[sf[:, 2]] - sp[sf[:, 0]])
            surface_orient = np.where(
                np.einsum("ij,ij->i", n_sub, n_par) >= 0, 1, -1
            ).astype(np.int8)
            conforming = True
        else:
            warnings.warn("conforming mapping lost sub-faces at finalize; "
                          "falling back to non-conforming", stacklevel=2)
            surface_parent = None

    # vertex -> incident tets CSR
    NV = verts.shape[0]
    vt_rows = tets.reshape(-1)
    vt_tets = np.repeat(np.arange(tets.shape[0]), 4)
    order = np.argsort(vt_rows, kind="stable")
    vt_data = vt_tets[order]
    vt_indptr = np.searchsorted(vt_rows[order], np.arange(NV + 1))

    return TetMesh(
        vertices=verts,
        tets=tets,
        faces=faces,
        tet_face=tet_face,
        tet_face_sign=tet_face_sign,
        vt_indptr=vt_indptr,
        vt_data=vt_data,
        n_src=int(order_src.shape[0]),
        src_vertex=src_vertex,
        n_snapped=n_snapped,
        n_split=n_split,
        conforming=conforming,
        surface_faces=surface_faces,
        surface_parent=surface_parent if conforming else None,
        surface_orient=surface_orient,
    )


def _same_orientation(f1: np.ndarray, f2: np.ndarray) -> np.ndarray:
    """True where triangle f1 is an even permutation of f2 (row-wise)."""
    same = np.zeros(f1.shape[0], dtype=bool)
    for r in ((0, 1, 2), (1, 2, 0), (2, 0, 1)):
        same |= np.all(f1 == f2[:, r], axis=1)
    return same
