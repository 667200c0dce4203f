"""Crouzeix-Raviart face path for conforming tet meshes (port of
shm3d.tet.cr_solver).

The default Step 3 for triangle meshes whose tet mesh conforms to the
surface: FEM on per-face (nonconforming CR) elements, with the level-set
constraints applied to the tet faces lying on the source surface, then an
L2 projection of the face values onto the vertices.

Host preparation (:meth:`CRPath.prepare`) is the JAX package's code,
copied: at production sizes (float32, nnz >= PAGED_MIN_NNZ) the face space
is relabeled by a Morton order on face barycenters and the face operator L
is stored paged (solve/pell.py) and uploaded as sliced ELL, so every L
application -- the CG matvec and the AMG V-cycle's level-0 smoothing --
runs the sliced-ELL kernel.  The
solves run on the device in the compute dtype, each as one unbounded CG
(the JAX package's bounded chunks answer the TPU runtime's watchdog), with
host f64 defect correction (tet/solver._refined_solve).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..config import LevelSetConstraint, SignedHeatOptions
from . import fem
from .mesher import TetMesh
from ..utils import order

from .._device import resolve_device, torch_dtype
from ..solve import amg, ell, pell
from ..utils import tree as tree_mod
from .solver import (_group_projector, _mg_or_jacobi, _pcg, _refined_solve,
                     _run_chunked, _zeroset_solve)

#: store CR operators paged at or above this nnz (float32 only)
PAGED_MIN_NNZ = 2_000_000


def find_surface_faces(mesh: TetMesh, src_faces: np.ndarray) -> Optional[np.ndarray]:
    """Global tet-face ids matching the source triangles (sorted-triple
    lookup).  Returns None if any source face is missing (non-conforming)."""
    NV = mesh.n_vertices
    assert NV < (1 << 21)

    def pack(tris):
        t = np.sort(np.asarray(tris, dtype=np.int64), axis=1)
        return (t[:, 0] << 42) | (t[:, 1] << 21) | t[:, 2]

    face_keys = pack(mesh.faces)
    order_k = np.argsort(face_keys)
    skeys = face_keys[order_k]
    want = pack(src_faces)
    pos = np.searchsorted(skeys, want)
    ok = (pos < skeys.shape[0]) & (skeys[np.minimum(pos, skeys.shape[0] - 1)] == want)
    if not ok.all():
        return None
    return order_k[pos]


def _cr_divergence(Y: torch.Tensor, div_tets2: torch.Tensor,
                   div_nvec2: torch.Tensor) -> torch.Tensor:
    """Integrated divergence onto faces: div[f] = sum over the <= 2 incident
    tets of n_f(outward) . Y_tet, in gather form ((nf, 2) incident-tet ids,
    (nf, 2, 3) signed normals, zero rows padding boundary faces)."""
    g = Y.index_select(0, div_tets2.reshape(-1)).view(div_nvec2.shape)
    return torch.einsum("fkj,fkj->f", div_nvec2, g)


def _cr_none_solve(b, x0, L, diag, h, tol, maxiter, graph=None):
    """Singular CR Poisson solve: L phi = b, constants deflated (b
    pre-deflated by the caller)."""
    def matvec(x):
        y = pell.apply(L, x)
        return y - y.mean()

    # the hierarchy is built on the raw operator (deflation lives outside it)
    mg = _mg_or_jacobi(h, diag, matvec0=lambda v: pell.apply(L, v))

    def precond(r):
        z = mg(r)
        return z - z.mean()

    return _pcg(matvec, b, x0, precond, tol, maxiter, graph)


def _cr_multiple_solve(b, x0, L, diag, group_elems, group_ids, group_winv,
                       n_groups: int, h, tol, maxiter, graph=None):
    """MULTIPLE mode via projected CG: solve P L P u = P div with P the
    componentwise averaging, the mean deflated as well (``b`` is
    pre-projected by the caller)."""
    pgroup = _group_projector(group_elems, group_ids, group_winv, n_groups)

    def proj(v):
        w = pgroup(v)
        return w - w.mean()

    def matvec(x):
        # x stays in the subspace along the recurrence, so P L P x = P (L x)
        return proj(pell.apply(L, x))

    mg = _mg_or_jacobi(h, diag, matvec0=lambda v: pell.apply(L, v))
    precond = lambda r: proj(mg(r))
    return _pcg(matvec, b, x0, precond, tol, maxiter, graph)


def _project_solve(bvec, x0, P, p_diag, tol, maxiter, shift=0.0, graph=None):
    """(A^T M A + shift I) w = b, SPD, Jacobi-preconditioned."""
    def matvec(x):
        return pell.apply(P, x) + shift * x

    return _pcg(matvec, bvec, x0, lambda r: r / p_diag, tol, maxiter, graph)


# --- projection regularization on sliver-bearing recovery meshes ----------

PROJ_SHIFT_REL = 1e-8  # relative Tikhonov shift on the projection Gram
PROJ_WEAK_REL = 1e-6   # mass-starved vertex flag threshold


def projection_regularization(p_diag: np.ndarray):
    """(shift, weak_vertex_ids) for the L2 face->vertex projection Gram: a
    shift of 1e-8 x the median diagonal, and the vertices whose Gram row is
    below 1e-6 x the median (repaired by ``repair_mass_starved``)."""
    pos = p_diag[p_diag > 0]
    med = float(np.median(pos)) if pos.size else 1.0
    shift = PROJ_SHIFT_REL * med
    weak = np.nonzero(p_diag < PROJ_WEAK_REL * med)[0].astype(np.int64)
    return shift, weak


def repair_mass_starved(w: np.ndarray, weak: np.ndarray, tets: np.ndarray,
                        sweeps: int = 3) -> np.ndarray:
    """Replace mass-starved vertices' projected values by the mean of their
    tet-edge neighbors (host; healthy neighbors preferred)."""
    if weak.size == 0:
        return w
    weak_set = {int(v) for v in weak}
    nbrs = {int(v): set() for v in weak}
    mask = np.isin(tets, weak).any(axis=1)
    for t in tets[mask]:
        for v in t:
            if int(v) in weak_set:
                for u in t:
                    if int(u) != int(v):
                        nbrs[int(v)].add(int(u))
    w = np.array(w, dtype=np.float64, copy=True)
    for _ in range(sweeps):
        for v in weak:
            nb = [u for u in nbrs[int(v)] if u not in weak_set] or list(nbrs[int(v)])
            if nb:
                w[int(v)] = float(np.mean(w[nb]))
    return w


def _csr64(M):
    """Host defect-correction operators run f64; upcast f32-stored data
    once at load."""
    if M.dtype != np.float64:
        M = M.astype(np.float64)
    return M


def _first_P_from_cols(face_cols: np.ndarray, n_vertices: int):
    """Geometric face->vertex prolongator from its (nf, 3) vertex-column
    table (every value is 1/3)."""
    import scipy.sparse as sp

    nf = face_cols.shape[0]
    return sp.csr_matrix(
        (np.full(3 * nf, 1.0 / 3.0),
         (np.repeat(np.arange(nf, dtype=np.int64), 3),
          face_cols.reshape(-1).astype(np.int64))),
        shape=(nf, n_vertices))


def face_component_rows(surface_faces: np.ndarray, components) -> Tuple[np.ndarray, np.ndarray]:
    """MULTIPLE-mode equality rows over surface faces: the first face of
    each component is its root; every later face gets a (root, member)
    row."""
    comp = np.asarray(components)
    surface_faces = np.asarray(surface_faces, dtype=np.int64)
    roots, members = [], []
    seen = {}
    for local_idx, c in enumerate(comp):
        g = int(surface_faces[local_idx])
        c = int(c)
        if c not in seen:
            seen[c] = g
            continue
        roots.append(seen[c])
        members.append(g)
    return np.asarray(roots, np.int64), np.asarray(members, np.int64)


class CRPath:
    """Prepared CR operators for one conforming (mesh, surface) pair on one
    device, or on a device mesh.

    - :meth:`prepare` (static, host): every final-dtype device panel, the
      host f64 CSR operators of the defect correction and the default-mode
      (ZeroSet) AMG hierarchy, as a numpy-leaf tree;
    - ``__init__`` with ``prepared=`` moves that tree to the device;
    - :meth:`from_prepared` does the same for the tree that
      ``shm3d.tet.cr_solver.CRPath.prepare`` returns (read by field name;
      a JAX-package mesh converts with ``TetMesh.from_fields``).

    ``device_mesh`` (shm3d_torch.parallel.device_mesh; ``device`` becomes
    its first device): the operators in the sliced-ELL encoding (L at
    production sizes and the paged AMG levels) are split by rows over it
    (``parallel.rows``), everything else stays on the first device, so
    given one Y the face and projection solves equal one device's bit for
    bit.  The prepared tree is the one-device tree: shm3d pads its panels
    to the mesh size, the port splits at upload.
    """

    def __init__(self, mesh: TetMesh, surface_faces: np.ndarray = None,
                 dtype=np.float64, cr_ops=None, device="cpu",
                 prepared: Optional[dict] = None, device_mesh=None):
        self.mesh = mesh
        self.device_mesh = device_mesh
        self.device = resolve_device(device if device_mesh is None else device_mesh.first)
        if prepared is None:
            prepared = CRPath.prepare(mesh, surface_faces, dtype, cr_ops=cr_ops)
        self.nf = int(prepared["nf"])
        self.surface_faces = np.asarray(prepared["surface_faces"], np.int64)
        self._H = prepared["H_csr"].to_scipy()
        self._first_P_scipy = _first_P_from_cols(
            np.asarray(prepared["first_P_cols"]), int(prepared["n_vertices"]))
        self._P_scipy = _csr64(prepared["P_csr"].to_scipy())
        self._AtM_scipy = _csr64(prepared["AtM_csr"].to_scipy())
        self._proj_shift = float(prepared["proj_shift"])
        self._proj_weak = np.asarray(prepared["proj_weak"])
        self._mask64 = np.asarray(prepared["ell"]["surf_mask"], np.float64)
        self.np_dtype = np.dtype(np.asarray(prepared["ell"]["diag"]).dtype)
        self.dtype = torch_dtype(self.np_dtype.name)
        self._paged = isinstance(prepared["ell"]["L"], pell.PagedMat)
        dev = ell.device_put_tree(
            dict(a=prepared["ell"],
                 amg={k: (h.levels, h.coarse_inv)
                      for k, h in prepared["amg"].items()}),
            self.device, device_mesh)
        self.arrays = dev["a"]
        self._amg_cache = {
            LevelSetConstraint(k): amg.AMGHierarchy(
                lev, cinv, tuple(prepared["amg"][k].sizes), prepared["amg"][k].l0_nnz)
            for k, (lev, cinv) in dev["amg"].items()
        }
        # the CUDA graphs of the face and projection solves' iterations
        # (solve.graphs), beside the operators and hierarchies they read;
        # on a device mesh the row-split solves run eagerly
        self.graphs = None if device_mesh is not None else {}
        self.last_stats = {}

    @classmethod
    def from_prepared(cls, mesh: TetMesh, prepared: dict, device,
                      device_mesh=None) -> "CRPath":
        """A CRPath from the numpy-leaf tree of either package's ``prepare``
        (the JAX package's PagedMat/EllMat/SlicedEll/CSR64/AMGHierarchy
        leaves are read by field name, and so is a JAX-package mesh), on
        ``device`` or split over ``device_mesh``."""
        if not isinstance(mesh, TetMesh):
            mesh = TetMesh.from_fields(mesh)
        return cls(mesh, device=device, prepared=tree_mod.adopt(prepared),
                   device_mesh=device_mesh)

    @staticmethod
    def prepare(mesh: TetMesh, surface_faces: np.ndarray, dtype,
                cr_ops=None, eager_modes=(LevelSetConstraint.ZERO_SET,)) -> dict:
        """Host-side CR preparation (numpy-leaf tree; see the class
        docstring).  ``eager_modes``: constraint modes whose AMG
        hierarchies are built now; others are built on first use.

        At production sizes (float32, nnz >= PAGED_MIN_NNZ) the whole face
        space is relabeled by a Morton order on face barycenters and the
        solve operator stored paged; the permutation is baked into every
        face-indexed array here, and only the face->vertex projection
        crosses back, via the column-permuted A^T M."""
        np_dtype = np.dtype(dtype)
        nf = mesh.n_faces
        surface_faces = np.asarray(surface_faces, dtype=np.int64)
        cr = cr_ops if cr_ops is not None else fem.build_cr_operators(mesh)
        L = cr.L_scipy().tocsr()
        use_paged = np_dtype == np.float32 and L.nnz >= PAGED_MIN_NNZ
        df = cr.div_faces
        if use_paged:
            fb = np.asarray(mesh.vertices)[np.asarray(mesh.faces)].mean(axis=1)
            fperm = order.morton_order(fb)
            finv = order.inverse_permutation(fperm)
            L = L[fperm][:, fperm].tocsr()
            surface_faces = finv[surface_faces]  # positions preserved
            df = finv[df]
        # L_CR is assembled positive-(semi)definite: its diagonal is the
        # Jacobi scaling
        diag = np.asarray(L.diagonal())
        diag = np.where(diag > 0, diag, 1.0)

        A = cr.A_scipy()
        M = cr.M_scipy()
        AtM = (A.T @ M).tocsr()
        P = (AtM @ A).tocsr()
        if use_paged:
            AtM = AtM[:, fperm].tocsr()
        p_diag = np.asarray(P.diagonal())
        proj_shift, proj_weak = projection_regularization(p_diag)
        p_diag = np.where(np.abs(p_diag) > 0, p_diag, 1.0) + proj_shift

        arrays = dict(
            L=(pell.build_paged(L, np_dtype) if use_paged
               else ell.build_ell(L, np_dtype)),
            diag=diag.astype(np_dtype),
            # the projection Gram lives in the (unpermuted) vertex space;
            # its long-tailed row widths store sliced at production sizes
            P=(ell.build_sliced(P, np_dtype)
               if use_paged and P.nnz >= amg.SLICED_MIN_NNZ
               and ell.sliced_waste(P) > 1.5
               else ell.build_ell(P, np_dtype)),
            p_diag=p_diag.astype(np_dtype),
        )
        # divergence in gather form: (nf, K) incident tets + signed normals
        counts = np.bincount(df, minlength=nf)
        order_d = np.argsort(df, kind="stable")
        dfs = df[order_d]
        first = np.zeros(nf, np.int64)
        first[1:] = np.cumsum(counts)[:-1]
        pos = np.arange(dfs.size) - first[dfs]
        K = int(counts.max()) if counts.size else 1
        dtets2 = np.zeros((nf, K), np.int32)
        dnvec2 = np.zeros((nf, K, 3), np_dtype)
        dtets2[dfs, pos] = cr.div_tets[order_d]
        dnvec2[dfs, pos] = cr.div_nvec[order_d]
        arrays["divt"] = dtets2
        arrays["divn"] = dnvec2
        mask = np.ones(nf, np_dtype)   # 0 on constrained faces
        mask[surface_faces] = 0.0
        arrays["surf_mask"] = mask

        # geometric face->vertex first prolongator (the CR dof at a face
        # barycenter is the mean of the P1 values at its 3 vertices)
        faces_p = np.asarray(mesh.faces)
        if use_paged:
            faces_p = faces_p[fperm]
        first_P = _first_P_from_cols(faces_p, mesh.n_vertices)

        hierarchies = {}
        for mode in eager_modes:
            hierarchies[mode.value] = CRPath._build_hierarchy_host(
                L, mask.astype(np.float64), mode, np_dtype,
                first_P=first_P, paged=use_paged)
        # at production scale the projection Gram / RHS operators store f32
        # values; the face operator L stays f64 (it is the refinement target)
        host_dt = np.float32 if use_paged else np.float64
        return dict(
            nf=nf,
            surface_faces=surface_faces,
            ell=arrays,
            H_csr=ell.CSR64.from_scipy(L),
            P_csr=ell.CSR64.from_scipy(P, host_dt),
            AtM_csr=ell.CSR64.from_scipy(AtM, host_dt),
            first_P_cols=faces_p.astype(np.int32),
            n_vertices=int(mesh.n_vertices),
            proj_shift=float(proj_shift),
            proj_weak=proj_weak,
            amg=hierarchies,
        )

    @staticmethod
    def _build_hierarchy_host(H, mask64, mode, np_dtype, first_P=None,
                              paged: bool = False):
        if mode == LevelSetConstraint.ZERO_SET:
            H = amg.masked_operator(H, mask64)
        return amg.build_hierarchy_host(
            H, np_dtype, skip_level0_A=True, first_P=first_P,
            paged_min_nnz=PAGED_MIN_NNZ if paged else None)

    def _hierarchy(self, mode):
        """Per-constraint-mode AMG hierarchy (non-default modes are built on
        first use)."""
        if mode not in self._amg_cache:
            h = CRPath._build_hierarchy_host(
                self._H, self._mask64, mode, self.np_dtype,
                first_P=self._first_P_scipy, paged=self._paged)
            self._amg_cache[mode] = amg.hierarchy_to_device(h, self.device,
                                                            self.device_mesh)
        return self._amg_cache[mode]

    def integrate(self, Y: torch.Tensor, options: SignedHeatOptions,
                  src_face_components=None, src_face_areas=None) -> np.ndarray:
        """Full CR Step 3: face solve, then the L2 projection onto the
        vertices; returns phi per vertex (host f64).  Both solves run on the
        device in the compute dtype with host f64 defect correction."""
        a = self.arrays
        nf = self.nf
        nv = self.mesh.n_vertices
        tol, maxiter = options.resolved_solver_tol(), options.solver_maxiter
        div = _cr_divergence(Y, a["divt"], a["divn"])
        div64 = div.cpu().numpy().astype(np.float64)

        mode = options.level_set_constraint
        h = self._hierarchy(mode)
        solve_stats: dict = {}
        proj_stats: dict = {}
        refine_stats: dict = {}
        proj_refine_stats: dict = {}
        H64 = self._H
        zeros = torch.zeros(nf, dtype=self.dtype, device=self.device)
        graph = None if self.graphs is None else (self.graphs, ("face", mode))
        refined = lambda run, host_op, b64, stats: _refined_solve(
            run, host_op, b64, self.dtype, self.device, options, stats=stats)
        if mode == LevelSetConstraint.ZERO_SET:
            m64 = self._mask64
            b64 = m64 * div64
            host_op = lambda x: m64 * (H64 @ (m64 * x)) + (1.0 - m64) * x
            run = lambda b, tol=tol, maxiter=maxiter: _run_chunked(
                lambda x0, it: _zeroset_solve(
                    b, x0, a["L"], a["diag"], a["surf_mask"], h, tol, it, graph),
                zeros, maxiter, stats=solve_stats)
            phi_f, it1, r1 = refined(run, host_op, b64, refine_stats)
        elif mode == LevelSetConstraint.MULTIPLE:
            labels = np.asarray(src_face_components)
            _, gids = np.unique(labels, return_inverse=True)
            sizes = np.bincount(gids).astype(np.float64)
            n_groups = int(gids.max()) + 1
            elems = self.surface_faces
            g_elems = torch.as_tensor(elems, dtype=torch.int64, device=self.device)
            g_ids = torch.as_tensor(gids, dtype=torch.int64, device=self.device)
            g_winv = torch.as_tensor(1.0 / sizes, dtype=self.dtype, device=self.device)

            def proj64(v):
                v = np.array(v, copy=True)
                sums = np.bincount(gids, weights=v[elems], minlength=n_groups)
                v[elems] = (sums / sizes)[gids]
                return v - v.mean()

            b64 = proj64(div64)
            host_op = lambda x: proj64(H64 @ x)
            run = lambda b, tol=tol, maxiter=maxiter: _run_chunked(
                lambda x0, it: _cr_multiple_solve(
                    b, x0, a["L"], a["diag"], g_elems, g_ids, g_winv, n_groups,
                    h, tol, it, graph),
                zeros, maxiter, stats=solve_stats)
            phi_f, it1, r1 = refined(run, host_op, b64, refine_stats)
            phi_f = phi_f - self._face_shift64(phi_f, src_face_areas)
        else:
            b64 = div64 - div64.mean()
            host_op = lambda x: (lambda y: y - y.mean())(H64 @ x)
            run = lambda b, tol=tol, maxiter=maxiter: _run_chunked(
                lambda x0, it: _cr_none_solve(
                    b, x0, a["L"], a["diag"], h, tol, it, graph),
                zeros, maxiter, stats=solve_stats)
            phi_f, it1, r1 = refined(run, host_op, b64, refine_stats)
            phi_f = phi_f - self._face_shift64(phi_f, src_face_areas)

        # L2 projection to vertices: (A^T M A + shift I) w = A^T M phi_f
        shift = float(self._proj_shift)
        b64p = self._AtM_scipy @ phi_f
        P64 = self._P_scipy
        host_opp = lambda x: P64 @ x + shift * x
        zeros_v = torch.zeros(nv, dtype=self.dtype, device=self.device)
        runp = lambda b, tol=tol, maxiter=maxiter: _run_chunked(
            lambda x0, it: _project_solve(
                b, x0, a["P"], a["p_diag"], tol, it, shift=shift,
                graph=None if self.graphs is None else (self.graphs, "projection")),
            zeros_v, maxiter, stats=proj_stats)
        w, it2, r2 = refined(runp, host_opp, b64p, proj_refine_stats)
        self.last_stats = {"iters": int(it1), "residual": float(r1),
                           "proj_iters": int(it2), "proj_residual": float(r2),
                           "chunks": solve_stats.get("chunks", []),
                           "proj_chunks": proj_stats.get("chunks", []),
                           "amg_sizes": list(h.sizes),
                           "refine_pass_rels": refine_stats.get("refine_pass_rels", []),
                           "proj_refine_pass_rels": proj_refine_stats.get("refine_pass_rels", [])}
        if self._proj_weak.size:
            w = repair_mass_starved(w, self._proj_weak, np.asarray(self.mesh.tets))
        return w

    def _face_shift64(self, phi_f, src_face_areas):
        """Area-weighted mean of phi over the surface faces, host f64."""
        areas = np.asarray(src_face_areas, np.float64)
        vals = np.asarray(phi_f)[self.surface_faces]
        return float(np.sum(areas * vals) / np.sum(areas))
