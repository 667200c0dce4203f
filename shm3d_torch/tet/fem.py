"""FEM operators on tet meshes (host assembly -> device matvec arrays).

Array-based reimplementations of the reference's per-tet assembly loops:

- dual Laplacian of Alexa et al. 2020 "Properties of Laplace operators for
  tetrahedral meshes" (reference dualLaplacian,
  reference src/signed_heat_tet_solver.cpp:710-751, itself adapted from
  the LB3D reference code): per tet and ordered corner pair (i, j), the dual
  wedge spanned by (v_i, edge midpoint, circumcenter of face (i, j,
  turn[i][j]), tet circumcenter) contributes w = 6 vol(wedge)/|v_i - v_j|^2
  to the (i, j) edge weight;
- vertex divergence with the same weights (:753-788);
- Crouzeix-Raviart Laplacian / mass matrix / face divergence on tet faces
  (:609-670): L_ab = n_a . n_b / vol with area-weighted outward normals,
  M = 0.4 vol diag - 0.05 vol off-diag, div_f = sum_t n_f . Y_t;
- 1/3-averaging matrix faces -> vertices (:798-810).

Everything is assembled vectorized in NumPy as COO triplets, deduplicated to
CSR-like (rows-sorted) arrays that the device applies with
``jax.ops.segment_sum`` — no sparse library on the device path.  Degenerate
(zero-volume) tets — possible output of the stuffing mesher for exactly
coplanar inputs — contribute zero weights (guarded; the reference never
meets them because TetGen refuses degenerate output).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from .mesher import TetMesh

# turn[i][j]: third vertex completing face (i, j, turn[i][j]) of a tet
# (reference table, signed_heat_tet_solver.cpp:715)
_TURN = np.array(
    [[-1, 2, 3, 1], [3, -1, 0, 2], [1, 3, -1, 0], [2, 0, 1, -1]], dtype=np.int64
)
_ORDERED_PAIRS = [(i, j) for i in range(4) for j in range(4) if i != j]


def tet_circumcenters(verts: np.ndarray, tets: np.ndarray) -> np.ndarray:
    """(NT, 3) circumcenters via the 3x3 linear system
    2 (v_k - v_0) . c = |v_k|^2 - |v_0|^2 (batched closed form)."""
    t = verts[tets]  # (NT, 4, 3)
    A = t[:, 1:, :] - t[:, :1, :]  # (NT, 3, 3)
    b = 0.5 * (np.sum(t[:, 1:, :] ** 2, axis=2) - np.sum(t[:, :1, :] ** 2, axis=2))
    det = np.linalg.det(A)
    ok = np.abs(det) > 1e-300
    c = np.full((tets.shape[0], 3), np.nan)
    if np.any(ok):
        c[ok] = np.linalg.solve(A[ok], b[ok][..., None])[..., 0]
    return c


def face_circumcenters(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """Barycentric circumcenter of triangles (a, b, c), batched
    (reference faceCircumcenter, signed_heat_tet_solver.cpp:695-704)."""
    l0 = np.sum((b - c) ** 2, axis=-1)
    l1 = np.sum((a - c) ** 2, axis=-1)
    l2 = np.sum((a - b) ** 2, axis=-1)
    ba0 = l0 * (l1 + l2 - l0)
    ba1 = l1 * (l2 + l0 - l1)
    ba2 = l2 * (l0 + l1 - l2)
    s = ba0 + ba1 + ba2
    with np.errstate(invalid="ignore", divide="ignore"):
        cc = (ba0 / s)[..., None] * a + (ba1 / s)[..., None] * b + (ba2 / s)[..., None] * c
    return cc


def _wedge_volumes(verts: np.ndarray, tets: np.ndarray, clamp: bool = True) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per tet and ordered pair (i, j): wedge volume, edge weight
    w = 6 vol / |vi - vj|^2, and the edge vector (vj - vi).

    Returns (w (NT, 12), evec (NT, 12, 3), pair index arrays)."""
    t = verts[tets]  # (NT, 4, 3)
    cc = tet_circumcenters(verts, tets)  # (NT, 3)
    NT = tets.shape[0]
    w = np.zeros((NT, 12))
    evec = np.zeros((NT, 12, 3))
    for p, (i, j) in enumerate(_ORDERED_PAIRS):
        k = _TURN[i, j]
        vi, vj, vk = t[:, i], t[:, j], t[:, k]
        cf = face_circumcenters(vi, vj, vk)
        ce = 0.5 * (vi + vj)
        vol = np.einsum("ij,ij->i", np.cross(ce - vi, cf - vi), cc - vi) / 6.0
        d2 = np.sum((vi - vj) ** 2, axis=1)
        with np.errstate(invalid="ignore", divide="ignore"):
            wij = 6.0 * vol / d2
        wij = np.where(np.isfinite(wij), wij, 0.0)
        w[:, p] = wij
        evec[:, p] = vj - vi
    # degenerate tets: zero all weights
    a, b, c, d = t[:, 0], t[:, 1], t[:, 2], t[:, 3]
    tvol = np.abs(np.einsum("ij,ij->i", np.cross(b - a, c - a), d - a) / 6.0)
    scale = np.maximum(tvol.max(), 1e-300)
    bad = tvol < 1e-14 * scale
    w[bad] = 0.0
    if clamp:
        # Sliver tets (split insertion near faces/edges of the stuffing
        # lattice) produce huge negative dual weights that make H = -L lose
        # definiteness and stall/diverge f32 Krylov solves.  Clamp weights to
        # >= 0 ONLY in low-quality tets: the regular Kuhn lattice itself has
        # benign small negative weights (degenerate-Delaunay) that are needed
        # for linear precision, so a global clamp would bias the bulk
        # discretization.  The reference never needs this because TetGen
        # emits quality meshes.  Applied to the divergence weights too so the
        # (L, div) pair stays consistent.
        edges2 = np.zeros((tets.shape[0],))
        for p1 in range(4):
            for p2 in range(p1 + 1, 4):
                e2 = np.sum((t[:, p1] - t[:, p2]) ** 2, axis=1)
                edges2 = np.maximum(edges2, e2)
        with np.errstate(invalid="ignore", divide="ignore"):
            quality = 6.0 * np.sqrt(2.0) * tvol / np.maximum(edges2, 1e-300) ** 1.5
        sliver = quality < 0.02
        w[sliver] = np.maximum(w[sliver], 0.0)
        # (A per-tet magnitude cap on |w| was tried here — knot's short-edge
        # pairs reach w ~ 8.9e8 vs median 33 — and measured HARMFUL: capping
        # at 1e3x median tripled mid-range f64 PCG iteration counts
        # (1e-3 in 86 vs 14 iterations) by perturbing the discretization,
        # while the large weights themselves are harmless to f32 once the
        # operator is definite.  The actual f32-stall culprit was the
        # negative-diagonal indefiniteness repaired in
        # build_dual_laplacian.)
    return w, evec


@dataclasses.dataclass
class DualLaplacian:
    """COO arrays for L (NV x NV, negative semi-definite like the reference)
    and the matching divergence operator."""

    rows: np.ndarray      # (E,) sorted
    cols: np.ndarray      # (E,)
    vals: np.ndarray      # (E,)
    n: int
    # divergence: div[row] += dot(gvec, Y[tet])
    div_rows: np.ndarray  # (2 * 12 * NT,)
    div_tets: np.ndarray
    div_gvec: np.ndarray  # (2 * 12 * NT, 3)

    def to_scipy(self):
        import scipy.sparse as sp

        return sp.coo_matrix((self.vals, (self.rows, self.cols)), shape=(self.n, self.n)).tocsr()

    def matvec_np(self, x: np.ndarray) -> np.ndarray:
        out = np.zeros(self.n)
        np.add.at(out, self.rows, self.vals * x[self.cols])
        return out

    def divergence_np(self, Y: np.ndarray) -> np.ndarray:
        out = np.zeros(self.n)
        np.add.at(out, self.div_rows, np.einsum("ij,ij->i", self.div_gvec, Y[self.div_tets]))
        return out


def build_dual_laplacian(mesh: TetMesh, clamp: bool = True) -> DualLaplacian:
    verts, tets = mesh.vertices, mesh.tets
    NT, NV = tets.shape[0], verts.shape[0]
    w, evec = _wedge_volumes(verts, tets, clamp=clamp)

    vi = np.empty((NT, 12), dtype=np.int64)
    vj = np.empty((NT, 12), dtype=np.int64)
    for p, (i, j) in enumerate(_ORDERED_PAIRS):
        vi[:, p] = tets[:, i]
        vj[:, p] = tets[:, j]

    if clamp:
        # Targeted negative-diagonal repair: even with the sliver
        # clamp, a vertex whose star's negative (degenerate-Delaunay)
        # weights outweigh the positives gets diag(H) <= 0 — an
        # INDEFINITE operator (the knot recovery mesh had 2 such vertices
        # at diag -5 vs median +33, which stalled the production f32
        # vertex solve at rel 7e-2; with the repair the same solve's f32
        # floor measured 5e-5).  Zero the negative
        # weights on edges incident to such vertices: every affected
        # diagonal moves UP (a negative w contributes -w to both endpoint
        # diagonals of H), so a couple of passes converge; the edge-weight
        # form stays a valid Laplacian (constants annihilated) and the
        # divergence weights below inherit the repaired w.
        for _ in range(3):
            diag = np.zeros(NV)
            np.add.at(diag, vi.reshape(-1), w.reshape(-1))
            np.add.at(diag, vj.reshape(-1), w.reshape(-1))
            bad = diag <= 0
            if not bad.any():
                break
            edge_bad = (bad[vi] | bad[vj]) & (w < 0)
            if not edge_bad.any():
                break
            w = np.where(edge_bad, 0.0, w)

    wf = w.reshape(-1)
    vif = vi.reshape(-1)
    vjf = vj.reshape(-1)
    # triplets: (i,j,+w) (j,i,+w) (i,i,-w) (j,j,-w)
    rows = np.concatenate([vif, vjf, vif, vjf])
    cols = np.concatenate([vjf, vif, vif, vjf])
    vals = np.concatenate([wf, wf, -wf, -wf])
    rfirst, cfirst, vsum = _dedup(rows, cols, vals, NV)

    # divergence entries, pre-aggregated per (tet, corner): for each ordered
    # pair (i, j), div[vi] += w e . Y_t and div[vj] -= w e . Y_t — summing the
    # 24 pair contributions down to 4 per tet cuts the device scatter 6x.
    g = w[..., None] * evec  # (NT, 12, 3)
    gvec_agg = np.zeros((NT, 4, 3))
    for p, (i, j) in enumerate(_ORDERED_PAIRS):
        gvec_agg[:, i] += g[:, p]
        gvec_agg[:, j] -= g[:, p]
    div_rows = tets.reshape(-1)
    div_tets = np.repeat(np.arange(NT), 4)
    div_gvec = gvec_agg.reshape(-1, 3)
    # sort by row so the device segment_sum can use indices_are_sorted
    order = np.argsort(div_rows, kind="stable")
    div_rows, div_tets, div_gvec = div_rows[order], div_tets[order], div_gvec[order]
    return DualLaplacian(
        rows=rfirst, cols=cfirst, vals=vsum, n=NV,
        div_rows=div_rows, div_tets=div_tets, div_gvec=div_gvec,
    )


# ---------------------------------------------------------------------------
# Crouzeix-Raviart operators (conforming-mesh path)


def area_weighted_normals(mesh: TetMesh) -> np.ndarray:
    """(NF, 3) normals of the global faces in their stored orientation
    (reference areaWeightedNormalVector, signed_heat_tet_solver.cpp:854-863:
    n = 0.5 (a - c) x (b - c))."""
    v = mesh.vertices
    f = mesh.faces
    a, b, c = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
    return 0.5 * np.cross(a - c, b - c)


@dataclasses.dataclass
class CROperators:
    L_rows: np.ndarray
    L_cols: np.ndarray
    L_vals: np.ndarray
    M_rows: np.ndarray
    M_cols: np.ndarray
    M_vals: np.ndarray
    div_faces: np.ndarray   # (4 NT,)
    div_tets: np.ndarray
    div_nvec: np.ndarray    # (4 NT, 3) signed outward normals
    avg_faces: np.ndarray   # faces (NF, 3) for the 1/3 averaging matrix
    n_faces: int
    n_vertices: int

    def L_scipy(self):
        import scipy.sparse as sp
        return sp.coo_matrix((self.L_vals, (self.L_rows, self.L_cols)),
                             shape=(self.n_faces, self.n_faces)).tocsr()

    def M_scipy(self):
        import scipy.sparse as sp
        return sp.coo_matrix((self.M_vals, (self.M_rows, self.M_cols)),
                             shape=(self.n_faces, self.n_faces)).tocsr()

    def A_scipy(self):
        import scipy.sparse as sp
        NF = self.n_faces
        rows = np.repeat(np.arange(NF), 3)
        cols = self.avg_faces.reshape(-1)
        vals = np.full(3 * NF, 1.0 / 3.0)
        return sp.coo_matrix((vals, (rows, cols)), shape=(NF, self.n_vertices)).tocsr()

    def divergence_np(self, Y: np.ndarray) -> np.ndarray:
        out = np.zeros(self.n_faces)
        np.add.at(out, self.div_faces, np.einsum("ij,ij->i", self.div_nvec, Y[self.div_tets]))
        return out


def build_cr_operators(mesh: TetMesh) -> CROperators:
    NT, NF = mesh.n_tets, mesh.n_faces
    vols = np.abs(mesh.tet_volumes())
    normals = area_weighted_normals(mesh)  # global orientation
    # signed outward normals per (tet, corner)
    nrm = normals[mesh.tet_face] * mesh.tet_face_sign[..., None]  # (NT, 4, 3)

    # Sliver regularization: the CR stiffness scales as 1/vol
    # (reference :623-648), so near-degenerate recovery tets produce huge
    # near-singular couplings that stall Krylov solves.  Two caps, both
    # per-tet PSD-preserving (positive scalings of the tet's normal-Gram
    # contribution), so the assembled operator stays SPD after Dirichlet
    # elimination; the SciPy oracle builds the identical operator, so
    # device/oracle parity is exact:
    #   1. effective volume floored at a fraction of the median — NEVER
    #      zeroed: dropping a degenerate tet's contribution entirely gave
    #      faces shared by two degenerate tets an exactly ZERO row
    #      (measured on the recovered bunny_small: 5 sub-1e-14 tets -> 2
    #      zero rows -> "Factor is exactly singular" in the direct oracle);
    #   2. a flat "pancake" tet has near-cancelling LARGE face normals, so
    #      even the floored 1/vol leaves couplings ~1e6x typical; cap each
    #      tet's max |n_j . n_k| / vol_eff at 1e3x the median tet's.
    med = np.median(vols) if vols.size else 1.0
    vol_eff = np.maximum(vols, np.maximum(1e-3 * med, 1e-300))
    inv_vol = 1.0 / vol_eff
    nn_max = np.zeros(NT)
    for j in range(4):
        for k in range(j + 1, 4):
            nn_max = np.maximum(
                nn_max, np.abs(np.einsum("ij,ij->i", nrm[:, j], nrm[:, k]))
            )
    raw = nn_max * inv_vol
    cap = 1e3 * np.median(raw[raw > 0]) if (raw > 0).any() else np.inf
    inv_vol = inv_vol * np.minimum(1.0, cap / np.maximum(raw, 1e-300))

    # The mass matrix keeps the RAW volumes (reference :650-670): sliver
    # faces carry distorted values from the capped stiffness rows, and a
    # tiny mass is exactly what keeps them out of the L2 projection.
    # (A floored mass was measured to AMPLIFY the spikes: -2.9 -> -41 on
    # the recovered bunny_small.)  The residual near-zero rows of the
    # projection Gram are handled at the projection solve instead
    # (cr_solver.CRPath / oracle solve_cr: relative Tikhonov shift +
    # neighbor-average repair of mass-starved vertices).
    Lr, Lc, Lv = [], [], []
    Mr, Mc, Mv = [], [], []
    for j in range(4):
        fj = mesh.tet_face[:, j]
        Mr.append(fj); Mc.append(fj); Mv.append(0.4 * vols)
        for k in range(j + 1, 4):
            fk = mesh.tet_face[:, k]
            w = np.einsum("ij,ij->i", nrm[:, j], nrm[:, k]) * inv_vol
            Lr += [fj, fk, fj, fk]
            Lc += [fk, fj, fj, fk]
            Lv += [w, w, -w, -w]
            mw = -0.05 * vols
            Mr += [fj, fk]
            Mc += [fk, fj]
            Mv += [mw, mw]
    L_rows, L_cols, L_vals = _dedup(np.concatenate(Lr), np.concatenate(Lc), np.concatenate(Lv), NF)
    M_rows, M_cols, M_vals = _dedup(np.concatenate(Mr), np.concatenate(Mc), np.concatenate(Mv), NF)

    div_faces = mesh.tet_face.reshape(-1)
    div_tets = np.repeat(np.arange(NT), 4)
    div_nvec = nrm.reshape(-1, 3)

    return CROperators(
        L_rows=L_rows, L_cols=L_cols, L_vals=L_vals,
        M_rows=M_rows, M_cols=M_cols, M_vals=M_vals,
        div_faces=div_faces, div_tets=div_tets, div_nvec=div_nvec,
        avg_faces=mesh.faces, n_faces=NF, n_vertices=mesh.n_vertices,
    )


def _dedup(rows, cols, vals, n):
    """Sum duplicate (row, col) entries, returning canonical (row, col)
    order.  scipy's C++ COO->CSR conversion (counting sort by row + tiny
    per-row column sorts) measures 8.1 s vs 56.5 s for the packed-int64
    numpy argsort at knot's 53.8M entries on this host — the earlier
    reduceat form was itself the fix for a still-slower lexsort+add.at."""
    import scipy.sparse as sp

    idx = np.int32 if n < np.iinfo(np.int32).max else np.int64
    A = sp.coo_matrix((vals, (rows.astype(idx), cols.astype(idx))),
                      shape=(n, n)).tocsr()
    A.sum_duplicates()
    C = A.tocoo()
    return C.row, C.col, C.data
