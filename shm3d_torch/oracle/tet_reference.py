"""Float64 SciPy oracle for the tet-domain pipeline (copied from
shm3d/oracle/tet_reference.py, over the port's own tet modules).

Direct-solve transcription of the reference's Step-3 vertex path
(/root/reference/src/signed_heat_tet_solver.cpp:161-232,319-397) over the
same discretization as the device solver (shm3d_torch.tet):

- ZERO_SET: Dirichlet block elimination on the source vertices — splu on
  the interior block of L (reference blockDecomposeSquare +
  solvePositiveDefinite :169-180,336-350);
- MULTIPLE: KKT [[L, A^T], [A, 0]] [phi; mu] = [div; 0] with
  equality-to-root rows, spsolve (:181-220,352-394), then mean shift;
- NONE: particular solution of the singular system via lsqr, then mean
  shift (the shift cancels the constant ambiguity, :221-229,576-589).

The device path (matrix-free CG/MINRES) must match these to rel-L2 <= 1e-6
in float64.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from ..config import LevelSetConstraint, SignedHeatOptions
from ..geometry import pointcloud as pc_geom
from ..geometry import sources as src_mod
from ..geometry import surface as surf
from ..io.mesh_io import Mesh
from . import reference as grid_oracle
from ..tet import fem
from ..tet.mesher import TetMesh, build_tet_domain
from ..tet.solver import TetResult, _component_rows, integrate_greedily_tet


def solve_tet(geom, options: SignedHeatOptions = SignedHeatOptions()) -> TetResult:
    is_mesh = isinstance(geom, Mesh)
    sources = src_mod.from_geometry(geom)
    src_faces = None
    if is_mesh:
        src_pts = geom.vertices
        labels = surf.connected_components_vertices(geom)
        dual_areas = surf.vertex_dual_areas(geom)
        if geom.is_triangular and options.conforming:
            src_faces = geom.triangles()
    else:
        src_pts = geom.positions
        labels = pc_geom.connected_components(geom.positions)
        dual_areas = sources.weights
    mesh = build_tet_domain(
        src_pts, options.scale, options.h_coef,
        mean_area=float(np.mean(sources.weights)), src_faces=src_faces,
    )
    dual = fem.build_dual_laplacian(mesh)
    L = dual.to_scipy()
    n = mesh.n_vertices

    spacing = mesh.mean_node_spacing()
    lam = np.sqrt(1.0 / (options.t_coef * spacing ** 2))
    Y = grid_oracle.diffuse_vector_field(mesh.barycenters(), sources, lam)
    div = dual.divergence_np(Y)

    if options.fast_integration:
        phi = _greedy(mesh, Y, options, dual_areas)
        return TetResult(phi, mesh, Y)

    if mesh.conforming and options.use_crouzeix_raviart:
        # the reference's default Step 3 for conforming triangle meshes
        # (integrateVectorFieldToFaces, signed_heat_tet_solver.cpp:234-317)
        phi = solve_cr(mesh, geom, Y, options)
        return TetResult(phi, mesh, Y)

    mode = options.level_set_constraint
    if mode == LevelSetConstraint.ZERO_SET:
        V = mesh.n_src
        interior = np.arange(V, n)
        LII = L[interior][:, interior].tocsc()
        phi = np.zeros(n)
        phi[interior] = spla.splu(LII).solve(div[interior])
    elif mode == LevelSetConstraint.MULTIPLE:
        roots, members = _component_rows(labels, mesh.src_vertex)
        m = roots.shape[0]
        A = sp.coo_matrix(
            (
                np.concatenate([np.ones(m), -np.ones(m)]),
                (np.concatenate([np.arange(m), np.arange(m)]), np.concatenate([roots, members])),
            ),
            shape=(m, n),
        ).tocsr()
        KKT = sp.bmat([[L, A.T], [A, None]], format="csc")
        rhs = np.concatenate([div, np.zeros(m)])
        soln = spla.spsolve(KKT, rhs)
        phi = soln[:n]
        phi = phi - _shift(phi, mesh, dual_areas)
    else:
        # singular: exact zero-mean particular solution via a bordered
        # (mean-constraint) direct solve; the shift fixes the constant
        ones = np.ones((n, 1))
        B = sp.bmat([[L, ones], [ones.T, None]], format="csc")
        rhs = div - np.mean(div)
        phi = spla.spsolve(B, np.concatenate([rhs, [0.0]]))[:n]
        phi = phi - _shift(phi, mesh, dual_areas)
    return TetResult(phi, mesh, Y)


def _shift(phi: np.ndarray, mesh: TetMesh, dual_areas: np.ndarray) -> float:
    vals = phi[mesh.src_vertex]
    return float(np.sum(dual_areas * vals) / np.sum(dual_areas))


def _greedy(mesh: TetMesh, Y: np.ndarray, options: SignedHeatOptions, dual_areas: np.ndarray) -> np.ndarray:
    mode = options.level_set_constraint
    if mode == LevelSetConstraint.ZERO_SET:
        return integrate_greedily_tet(mesh, Y, np.unique(mesh.src_vertex))
    phi = integrate_greedily_tet(mesh, Y, np.array([0]))
    return phi - _shift(phi, mesh, dual_areas)


def solve_cr(mesh, geom, Y: np.ndarray, options: SignedHeatOptions) -> np.ndarray:
    """Direct-solve oracle for the full Crouzeix-Raviart Step 3 on a
    conforming mesh (all 3 constraint modes + L2 projection), mirroring
    tet.cr_solver.CRPath.integrate so the device path can be verified
    against it (reference :234-317)."""
    from ..tet import fem as fem_mod
    from ..tet.cr_solver import (face_component_rows, projection_regularization,
                                 repair_mass_starved)

    cr = fem_mod.build_cr_operators(mesh)
    L = cr.L_scipy()
    div = cr.divergence_np(Y)
    nf = cr.n_faces
    sfids = np.asarray(mesh.surface_faces, dtype=np.int64)
    sub_areas = mesh.face_areas()[sfids]
    mode = options.level_set_constraint

    if mode == LevelSetConstraint.ZERO_SET:
        keep = np.ones(nf, dtype=bool)
        keep[sfids] = False
        interior = np.nonzero(keep)[0]
        phi_f = np.zeros(nf)
        LII = L[interior][:, interior].tocsc()
        phi_f[interior] = spla.splu(LII).solve(div[interior])
    elif mode == LevelSetConstraint.MULTIPLE:
        comp = surf.connected_components_faces(geom)[mesh.surface_parent]
        roots, members = face_component_rows(sfids, comp)
        m = roots.shape[0]
        H = (-L).tocsr()
        A = sp.coo_matrix(
            (
                np.concatenate([np.ones(m), -np.ones(m)]),
                (np.concatenate([np.arange(m), np.arange(m)]),
                 np.concatenate([roots, members])),
            ),
            shape=(m, nf),
        ).tocsr()
        KKT = sp.bmat([[H, A.T], [A, None]], format="csc")
        rhs = np.concatenate([-div, np.zeros(m)])
        soln = spla.spsolve(KKT, rhs)
        phi_f = soln[:nf]
        phi_f = phi_f - _face_shift(phi_f, sfids, sub_areas)
    else:
        # exact zero-mean solution of the singular system via a bordered
        # (mean-constraint) direct solve; the device path's mean-projected
        # CG converges to the same representative, and the surface shift
        # cancels any constant difference
        H = (-L).tocsr()
        ones = np.ones((nf, 1))
        B = sp.bmat([[H, ones], [ones.T, None]], format="csc")
        soln = spla.spsolve(B, np.concatenate([-div - np.mean(-div), [0.0]]))
        phi_f = soln[:nf]
        phi_f = phi_f - _face_shift(phi_f, sfids, sub_areas)

    A = cr.A_scipy()
    M = cr.M_scipy()
    P = (A.T @ M @ A).tocsc()
    # same regularization + mass-starved repair as CRPath.integrate
    shift, weak = projection_regularization(np.asarray(P.diagonal()))
    P = P + shift * sp.eye(P.shape[0], format="csc")
    w = spla.spsolve(P, A.T @ (M @ phi_f))
    return repair_mass_starved(w, weak, np.asarray(mesh.tets))


def _face_shift(phi_f: np.ndarray, sfids: np.ndarray, areas: np.ndarray) -> float:
    """Area-weighted mean of phi over the surface (sub-)faces
    (averageFaceDataOnSource, signed_heat_tet_solver.cpp:558-573)."""
    return float(np.sum(areas * phi_f[sfids]) / np.sum(areas))


def solve_cr_zeroset(mesh, surface_faces: np.ndarray, Y: np.ndarray, tol: float = 1e-12):
    """Direct-solve oracle for the CR ZeroSet path
    (integrateVectorFieldToFaces, signed_heat_tet_solver.cpp:234-317):
    Dirichlet-eliminate surface faces on L_CR, L2-project to vertices,
    return -phi."""
    from ..tet import fem as fem_mod

    cr = fem_mod.build_cr_operators(mesh)
    L = cr.L_scipy()
    div = cr.divergence_np(Y)
    nf = cr.n_faces
    keep = np.ones(nf, dtype=bool)
    keep[surface_faces] = False
    interior = np.nonzero(keep)[0]
    phi_f = np.zeros(nf)
    LII = L[interior][:, interior].tocsc()
    phi_f[interior] = spla.splu(LII).solve(div[interior])
    A = cr.A_scipy()
    M = cr.M_scipy()
    P = (A.T @ M @ A).tocsc()
    w = spla.spsolve(P, A.T @ (M @ phi_f))
    return w  # see CRPath.integrate: outward-normal divergence needs no flip
