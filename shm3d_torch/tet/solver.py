"""Tet-domain solver (port of shm3d.tet.solver).

  host:   tet domain + FEM operator arrays + AMG hierarchies (NumPy/SciPy,
          the JAX package's code; cached in memory and on disk)
  device: Yukawa kernel at tet barycenters -> one of three Step-3 families,
          each device solve in the compute dtype with host f64 defect
          correction

For triangle meshes the domain conforms to the surface and Step 3 defaults
to the Crouzeix-Raviart face path (cr_solver.CRPath).  Polygon meshes, point
clouds, ``use_crouzeix_raviart=False`` and meshes whose conforming recovery
failed take the vertex (dual-Laplacian) path, with the three level-set
constraint modes:

- ZERO_SET: Dirichlet elimination on the source vertices (masked CG on the
  interior block of H = -L, positive definite there);
- MULTIPLE: 'phi constant per connected component', solved by projected CG
  (componentwise-averaging projector), no saddle;
- NONE: singular Poisson solve with the null direction deflated; the source
  mean shift fixes the constant afterwards.

``fast_integration`` integrates greedily by BFS on the host (sequential by
nature).  The disk artifact holds the discretization plus only the Step-3
operator family its first run needed; a later run in another mode builds
the missing family from the cached mesh and merges it back
(_ensure_cr_path / _ensure_vertex_ops + _upgrade_artifact).

Left behind from the JAX package (TPU or old-artifact workarounds, not
behaviour): the bounded, adaptively sized Krylov chunks and their cost
estimates (the TPU runtime's watchdog; here a solve is one CG), the
stall-detector state threaded across chunks, and the stale-artifact gate of
the vertex family's encoding version (this namespace never held an older
encoding).

On a device mesh (``SignedHeatTetSolver(mesh=)``, a
shm3d_torch.parallel.device_mesh) Step 1 runs the ring schedule over the
barycenters (K1's partial kernel on every hop, its merge kernel at the end)
and is gathered onto the mesh's first device, as in shm3d.  Step 3 splits
the operators in the sliced-ELL encoding by rows over the mesh
(``parallel.rows``: the face operator L and the vertex operator H in
float32, and the AMG levels stored paged; K2 on each block) and keeps the
vectors and the plain-encoded operators whole on the first device, so given
one Y it equals one device's Step 3 bit for bit.  shm3d instead pads its
host panels to the mesh size and keys its artifact by it; here the split is
made at upload, so the disk key and the artifact are the one device's, and
a mesh solver reads what a one-device solver wrote.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import os
import time
from typing import Optional

import numpy as np
import torch

from ..config import LevelSetConstraint, SignedHeatOptions
from ..geometry import pointcloud as pc_geom
from ..geometry import sources as src_mod
from ..geometry import surface as surf
from ..io.mesh_io import Mesh
from . import fem
from .mesher import MESHER_VERSION, TetMesh, build_tet_domain
from ..utils import checks, diskcache, treestore

from .._device import resolve_device, torch_dtype
from .._inputs import check_inputs
from ..ops.yukawa import yukawa_field
from ..parallel import rows, yukawa_field_ring
from ..solve import amg, ell, graphs, krylov, pell
from ..utils import tree as tree_mod
from ..utils.timing import PhaseTimer

# disk-cache namespace of the port's prepared tet artifacts, apart from the
# JAX package's ("tetprep", ...) so the two never read each other's trees;
# "c2": the mode-aware tree (vertex family, labels, dual areas)
_CACHE_NS = ("tetprep_torch", "c2")


@dataclasses.dataclass
class TetResult:
    phi: np.ndarray          # (NV,) float64, per tet-mesh vertex
    mesh: TetMesh
    Y: Optional[np.ndarray] = None  # (NT, 3) normalized field at barycenters

    def phi_at_sources(self) -> np.ndarray:
        """phi sampled at the input source vertices."""
        return self.phi[self.mesh.src_vertex]


def _stall_window(dtype) -> int:
    """float32 solves hit their roundoff floor and must stop instead of
    burning maxiter; f64 AMG-CG can plateau for long stretches near machine
    precision and needs a far more patient guard."""
    return 60 if dtype == torch.float32 else 1000


def _run_chunked(solve_fn, x0, maxiter: int, stats: Optional[dict] = None):
    """One unbounded device solve, ``solve_fn(x0, maxiter) -> (x, iters,
    rel)``.  (The JAX package's bounded chunks answer the TPU runtime's
    watchdog; off the TPU it runs exactly this one solve.)  ``stats``
    accumulates a ``chunks`` list of {iters, s} per solve."""
    t0 = time.perf_counter()
    x, iters, resid = solve_fn(x0, maxiter)
    if stats is not None:
        stats.setdefault("chunks", []).append(
            {"iters": int(iters), "s": round(time.perf_counter() - t0, 3)})
    return x, int(iters), resid


def _refined_solve(run, host_op, b64, dtype, device, options, tm=None,
                   stats=None):
    """Mixed-precision solve of A x = b with f64 defect correction.

    ``run(b_device, tol=, maxiter=)`` performs one device solve of A x = b
    from x0 = 0; ``host_op(x64)`` applies the same operator (mask or
    projection included) in f64 on the host.  Float32 solves get
    correction passes: the budget comes from the measured starting
    residual (``options.refine_pass_budget``), each pass is capped at
    max(2 x primary iterations, 60) iterations and runs at the loose
    ``refine_solver_tol``, and a pass that fails to contract the f64
    residual 10x stops the correction.  Per-pass f64 residuals land in
    ``stats["refine_pass_rels"]``.  Returns (x64, iters_total, rel_res)."""
    b64 = np.asarray(b64, np.float64)
    put = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    x, iters, res = run(put(b64))
    x64 = x.cpu().numpy().astype(np.float64)
    total = int(iters)
    rel = float(res)
    bnorm = float(np.linalg.norm(b64))
    if options.refine_steps > 0 and dtype == torch.float32 and bnorm > 0:
        r64 = b64 - host_op(x64)
        rel = float(np.linalg.norm(r64)) / bnorm
        rels = [rel] if stats is None else stats.setdefault("refine_pass_rels", [rel])
        budget = options.refine_pass_budget(rel)
        cap = max(2 * max(int(iters), 1), 60)
        for _ in range(budget):
            if not np.isfinite(rel) or rel <= options.refine_target:
                break
            d, it2, _ = run(put(r64), tol=options.refine_solver_tol, maxiter=cap)
            x64 = x64 + d.cpu().numpy().astype(np.float64)
            total += int(it2)
            r64 = b64 - host_op(x64)
            new_rel = float(np.linalg.norm(r64)) / bnorm
            rels.append(new_rel)
            # a pass costs about a primary solve, so one that fails to
            # contract 10x means the float32 correction floor is reached
            stalled = not np.isfinite(new_rel) or new_rel > 0.1 * rel
            rel = new_rel if np.isfinite(new_rel) else rel
            if stalled:
                break
        if tm is not None:
            tm.note(f"defect correction: rel_res={rel:.2e} (f64, "
                    f"{len(rels) - 1}/{budget} passes)")
    return x64, total, rel


# ---------------------------------------------------------------------------
# device solves


def _mg_or_jacobi(h, diag, matvec0=None):
    """AMG V-cycle when a hierarchy was built, else Jacobi.  ``matvec0``
    applies the level-0 operator (hierarchies are built with skip_level0_A,
    reusing the solve's own operator instead of duplicating it)."""
    if h.sizes:
        return amg.make_preconditioner_parts(h.levels, h.coarse_inv, h.sizes,
                                             matvec0=matvec0)
    return lambda r: r / diag


def _pcg(matvec, b, x0, precond, tol, maxiter, graph=None):
    """Preconditioned CG stopped relative to ||b|| in the preconditioner's
    norm, with the dtype's stall window; returns (x, iterations, relative
    residual in that norm).  ``graph``: (dict, key) of the CUDA graphs of
    the solve (``solve.graphs``), kept beside the operator and hierarchy
    they read; on one CUDA device the solve is their setup graph (||b||_M
    inside) and the chunk graph of its loop."""
    res = krylov.cg_run(matvec, b, x0=x0, precond=precond, tol=tol, maxiter=maxiter,
                        stall_window=_stall_window(b.dtype),
                        runner=None if graph is None else graphs.runner(*graph, b))
    return (res.x, res.iterations,
            res.residual / max(res.rhs_mnorm, torch.finfo(b.dtype).tiny))


def _group_projector(group_elems, group_ids, group_winv, n_groups: int,
                     group_u=None):
    """Orthogonal projector onto {v : v proportional to ``group_u`` over each
    component's element set}; ``group_u`` None means constants
    (componentwise averaging, ``group_winv`` = 1 / size), else
    ``group_winv`` = 1 / sum of u^2 over the component."""
    def project(v):
        vals = v.index_select(0, group_elems)
        if group_u is not None:
            vals = group_u * vals
        # accumulate=True sums in a fixed order (index_add's CUDA atomics
        # do not; see ell.fold_tail)
        sums = torch.zeros(n_groups, dtype=v.dtype, device=v.device).index_put(
            (group_ids,), vals, accumulate=True)
        out = (sums * group_winv).index_select(0, group_ids)
        if group_u is not None:
            out = out * group_u
        return v.index_copy(0, group_elems, out)

    return project


def _divergence(Y, div_rows, div_tets, div_gvec, n: int) -> torch.Tensor:
    """Integrated divergence onto the vertices: a segment sum of
    gvec . Y[tet] over ``div_rows`` (int64).  ``index_put`` with
    accumulate=True sums in a fixed order, so two calls agree bit for bit
    (``index_add_``'s CUDA atomics do not)."""
    vals = torch.einsum("ij,ij->i", div_gvec, Y.index_select(0, div_tets))
    return torch.zeros(n, dtype=Y.dtype, device=Y.device).index_put(
        (div_rows,), vals, accumulate=True)


# The vertex (dual-Laplacian) solves run in SYMMETRICALLY EQUILIBRATED
# variables: the device operator is S H S with S = diag(1/sqrt(diag H))
# (built on the host, _build_vertex_ops); the caller maps rhs and solution
# with x = S y, b_s = S b.  The dual Laplacian's weights span many orders of
# magnitude on graded meshes and float32 CG floors near 1e-2 relative
# residual on the raw operator from value rounding alone; the scaled
# operator has unit diagonal and reaches the ordinary float32 floor.
# Exact-arithmetic iterates are identical (diagonal preconditioning ==
# equilibration), so f64 runs are unaffected.
# CAUTION (modes without Dirichlet rows): the scaled operator's null space
# is S^{-1} 1 = sqrt(diag H), NOT constants -- the deflations inside
# _none_solve / _multiple_solve use the ``vnull`` direction, and the
# MULTIPLE group subspace 'phi constant per component' maps to 'y
# proportional to sqrt(diag H) per component' (weighted group projection).
# The Galerkin condition is invariant under the congruence, so the unscaled
# answer is unchanged up to the null component, which _shift fixes in
# original variables either way.


def _zeroset_solve(b, x0, H, diag, mask, h, tol, maxiter, graph=None):
    """Dirichlet solve: x = 0 where ``mask`` is 0, H_II x_I = b_I (the
    vertex path's source vertices, the CR path's surface faces).
    ``graph`` as in ``_pcg``."""
    def matvec(x):
        return mask * pell.apply(H, mask * x) + (1.0 - mask) * x

    # the hierarchy is built on the same masked operator -> matvec0 = matvec
    precond = _mg_or_jacobi(h, diag, matvec0=matvec)
    x, iters, rel = _pcg(matvec, b, x0, precond, tol, maxiter, graph)
    return x * mask, iters, rel


def _none_solve(b, x0, H, diag, vnull, h, tol, maxiter, graph=None):
    """Singular Poisson solve in equilibrated variables: H y = b with the
    scaled null direction ``vnull`` (unit sqrt(diag) vector) deflated."""
    defl = lambda v: v - vnull * torch.dot(vnull, v)
    b = defl(b)

    def matvec(x):
        return defl(pell.apply(H, x))

    mg = _mg_or_jacobi(h, diag, matvec0=lambda v: pell.apply(H, v))
    return _pcg(matvec, b, x0, lambda r: defl(mg(r)), tol, maxiter, graph)


def _multiple_solve(b, x0, H, diag, group_elems, group_ids, group_u,
                    group_uinv, vnull, n_groups: int, h, tol, maxiter, graph=None):
    """MULTIPLE mode via projected CG in equilibrated variables: solve
    P H P u = P b with P the ``group_u``-weighted per-group projection
    composed with the ``vnull`` deflation (the scaled operator is singular
    on vnull, as the raw one is on constants; the mean shift fixes that
    component afterwards, in original variables)."""
    pgroup = _group_projector(group_elems, group_ids, group_uinv, n_groups,
                              group_u=group_u)

    def proj(v):
        w = pgroup(v)
        return w - vnull * torch.dot(vnull, w)

    b = proj(b)

    def matvec(x):
        return proj(pell.apply(H, x))

    mg = _mg_or_jacobi(h, diag, matvec0=lambda v: pell.apply(H, v))
    return _pcg(matvec, b, x0, lambda r: proj(mg(r)), tol, maxiter, graph)


# ---------------------------------------------------------------------------
# host helpers


def integrate_greedily_tet(mesh: TetMesh, Y: np.ndarray, seeds: np.ndarray) -> np.ndarray:
    """FIFO BFS line integration over the vertex->tet adjacency:
    phi[next] = phi[curr] + Y_tet . (v_next - v_curr)."""
    NV = mesh.n_vertices
    phi = np.zeros(NV)
    visited = np.zeros(NV, dtype=bool)
    visited[seeds] = True
    queue = collections.deque(int(s) for s in seeds)
    verts, tets = mesh.vertices, mesh.tets
    indptr, data = mesh.vt_indptr, mesh.vt_data
    while queue:
        curr = queue.popleft()
        p = verts[curr]
        for tid in data[indptr[curr]:indptr[curr + 1]]:
            for nb in tets[tid]:
                if visited[nb]:
                    continue
                phi[nb] = phi[curr] + float(np.dot(Y[tid], verts[nb] - p))
                visited[nb] = True
                queue.append(int(nb))
    return phi


def _vertex_scale(H_scipy) -> np.ndarray:
    """Equilibration scale s = 1/sqrt(diag H) (f64); a non-positive
    diagonal maps to scale 1, so the row passes through unscaled."""
    d = np.asarray(H_scipy.diagonal())
    return 1.0 / np.sqrt(np.where(d > 0, d, 1.0))


def _equilibrated(H_scipy, s: Optional[np.ndarray] = None):
    """S H S as CSR (unit diagonal wherever diag H > 0)."""
    import scipy.sparse as sp

    if s is None:
        s = _vertex_scale(H_scipy)
    S = sp.diags(s)
    return (S @ H_scipy @ S).tocsr()


def _component_rows(labels: np.ndarray, src_vertex: np.ndarray):
    """Multiple-mode constraint rows: for each source vertex w (per
    component, excluding the component's first vertex v0), a row
    (+1 at v0, -1 at w) -- equality of every member to the root."""
    roots, members = [], []
    seen_root = {}
    seen_members = {}
    for idx in range(labels.shape[0]):
        c = labels[idx]
        mv = src_vertex[idx]
        if c not in seen_root:
            seen_root[c] = mv
            seen_members[c] = {int(mv)}
            continue
        if int(mv) in seen_members[c]:
            # coincident input vertices merged to one mesh vertex: a second
            # (root, mv) row would make the KKT matrix singular
            continue
        seen_members[c].add(int(mv))
        roots.append(seen_root[c])
        members.append(mv)
    return np.asarray(roots, dtype=np.int64), np.asarray(members, dtype=np.int64)


# ---------------------------------------------------------------------------
# solver


class SignedHeatTetSolver:
    """Stateful tet solver with the reference caching contract: the
    discretization and operators of a geometry are built once per
    (geometry, options cache key) and reused by later solves.

    ``device`` (default "cuda") is required to exist: "cuda" without a
    visible card raises, and nothing falls back to the CPU.  With a ``mesh``
    (shm3d_torch.parallel.device_mesh, 1-D or 2-D) the solve runs on it (the
    module docstring) and ``device`` is its first device; another device
    raises."""

    #: device-side vertex-path operator keys (built by _build_vertex_ops)
    VERTEX_KEYS = ("H_ell", "diagH", "div_rows", "div_tets", "div_gvec",
                   "vscale", "vnull")

    def __init__(self, device=None, mesh=None):
        self.mesh = mesh
        if mesh is None:
            self.device = resolve_device("cuda" if device is None else device)
        else:
            for d in mesh.devices:
                resolve_device(d)
            self.device = resolve_device(mesh.first)
            if device is not None and _canonical(device) != _canonical(self.device):
                raise ValueError(f"device {device!r} is not the mesh's first device "
                                 f"{self.device}")
        self._cache = {}
        self.last_stats = {}

    def compute_distance(self, geom, options: SignedHeatOptions = SignedHeatOptions()) -> TetResult:
        check_inputs(geom, options)
        torch_dtype(options.dtype)  # rejects an unknown dtype before meshing
        tm = PhaseTimer(self.device, verbose=options.verbose)
        self.last_stats = {}
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)

        with tm.phase("tet precompute (mesh + operators)"):
            key = (diskcache.geometry_content_hash(geom), options.cache_key(),
                   MESHER_VERSION, os.environ.get("SHM3D_GRADED", ""), 1)
            cached = self._cache.get(key)
            if cached is None:
                prepared = None
                if options.disk_cache:
                    stored = treestore.load_tree(_CACHE_NS + key)
                    if stored is not None:
                        prepared = tree_mod.from_plain(stored)
                        tm.note("operator cache: disk hit (mmap)")
                if prepared is None:
                    prepared = self._prepare_host(geom, options)
                    if options.disk_cache:
                        treestore.save_tree(_CACHE_NS + key, tree_mod.to_plain(prepared))
                cached = self._to_device(prepared)
                cached["_key"] = key  # for in-place artifact upgrades
                self._cache[key] = cached
        mesh: TetMesh = cached["mesh"]

        lam = math.sqrt(1.0 / (options.t_coef * cached["spacing"] ** 2))

        with tm.phase("steps 1&2 (Yukawa at tet barycenters)"):
            if self.mesh is not None:
                Y = yukawa_field_ring(cached["barys"], cached["points"], cached["vectors"],
                                      lam, self.mesh).gather()
            else:
                Y = yukawa_field(cached["barys"], cached["points"], cached["vectors"], lam)
            checks.check_unit_field("tet Step 2 field", Y)

        cr_wanted = options.use_crouzeix_raviart and not options.fast_integration
        if (cr_wanted and cached.get("cr_path") is None
                and not cached.get("_cr_unsupported")):
            # mode upgrade on an artifact whose first run didn't need CR:
            # minutes of host work at scale, so it gets a phase of its own
            with tm.phase("tet precompute (CR face operators, mode upgrade)"):
                self._ensure_cr_path(cached, geom, options)
        if options.fast_integration:
            self.last_stats["step3_path"] = "greedy"
            with tm.phase("step 3 (greedy BFS, host)"):
                phi = self._greedy(mesh, Y.cpu().numpy().astype(np.float64),
                                   cached, options)
        elif cr_wanted and cached.get("cr_path") is not None:
            self.last_stats["step3_path"] = "crouzeix-raviart"
            # the reference's default for conforming triangle meshes
            with tm.phase("step 3 (Crouzeix-Raviart face solve)"):
                phi = cached["cr_path"].integrate(
                    Y, options,
                    src_face_components=cached["cr_face_components"],
                    src_face_areas=cached["cr_face_areas"],
                )
            self.last_stats.update(cached["cr_path"].last_stats)
        else:
            self.last_stats["step3_path"] = "vertex"
            with tm.phase("step 3 (divergence + constrained solve)"):
                phi = self._integrate(Y, mesh, cached, options, tm)

        phi_host = np.asarray(phi, dtype=np.float64)
        checks.check_finite("tet phi", phi_host)
        if self.mesh is not None:
            self.last_stats["mesh"] = self._mesh_stats(cached, options)
        self.last_stats["phases"] = tm.as_dict()
        if self.device.type == "cuda":
            self.last_stats["mem_peak_mb"] = (
                torch.cuda.max_memory_allocated(self.device) / 1e6)
        return TetResult(phi_host, mesh, Y.cpu().numpy().astype(np.float64))

    # -- internals

    def _mesh_stats(self, cached, options) -> dict:
        """``last_stats["mesh"]``: the mesh, Step 1's schedule, the row
        blocks of the Step-3 operators this solve applied (None for one
        kept whole) and the first AMG level kept whole."""
        path = self.last_stats["step3_path"]
        mode = options.level_set_constraint
        ops, h, op0 = {}, None, None
        if path == "crouzeix-raviart":
            cr = cached["cr_path"]
            ops = {"L": cr.arrays["L"], "P": cr.arrays["P"]}
            h, op0 = cr._hierarchy(mode), ops["L"]
        elif path == "vertex":
            ops = {"H": cached["H_ell"]}
            h, op0 = cached["amg"][mode], ops["H"]
        return dict(self.mesh.describe(), step1="ring",
                    row_blocks={k: rows.block_rows(op) for k, op in ops.items()},
                    amg_first_whole_level=(None if h is None
                                           else rows.first_whole_level(h.levels, op0)))

    def _prepare_host(self, geom, options) -> dict:
        """Full host precompute as a persistable numpy-leaf tree: tet
        domain, source quadrature, component labels, and the Step-3
        operator family this run's mode needs (below), everything in final
        dtypes, so a disk load is an mmap plus one device transfer."""
        np_dtype = np.dtype(options.dtype)
        sources = src_mod.from_geometry(geom)
        is_mesh = isinstance(geom, Mesh)
        mean_area = float(np.mean(sources.weights))
        if is_mesh and geom.is_triangular:
            src_pts = geom.vertices
            labels = surf.connected_components_vertices(geom)
            dual_areas = surf.vertex_dual_areas(geom)
        elif is_mesh:
            # polygon mesh: the reference wraps the vertices as a point
            # cloud (non-conforming fallback) and takes tufted vertex dual
            # areas
            src_pts = geom.vertices
            labels = surf.connected_components_vertices(geom)
            dual_areas = pc_geom.point_dual_areas(geom.vertices)
        else:
            src_pts = geom.positions
            labels = pc_geom.connected_components(geom.positions)
            dual_areas = sources.weights
        # the scale option is honored on both domains (the reference's tet
        # path always meshes with scale=2)
        src_faces = None
        if is_mesh and geom.is_triangular and options.conforming:
            # surface-conforming domain, the reference default for triangle
            # meshes
            src_faces = geom.triangles()
        mesh = build_tet_domain(src_pts, options.scale, options.h_coef,
                                mean_area=mean_area, src_faces=src_faces)
        # Crouzeix-Raviart surface ids.  Input faces may be subdivided into
        # coplanar sub-faces by the recovery; constraints and the mean shift
        # then act on the sub-faces, with components inherited from the
        # parent input face.
        surf_ids = cr_face_components = cr_face_areas = None
        if is_mesh and geom.is_triangular:
            surf_ids, cr_face_components, cr_face_areas = \
                SignedHeatTetSolver._cr_surface_info(mesh, geom, sources)

        labels = np.asarray(labels, np.int64)
        comp_root, comp_member = _component_rows(labels, mesh.src_vertex)
        dev = dict(
            barys=np.asarray(mesh.barycenters(), np_dtype),
            points=np.asarray(sources.points, np_dtype),
            vectors=np.asarray(sources.vectors(), np_dtype),
            dual_areas=np.asarray(dual_areas, np_dtype),
            comp_root=np.asarray(comp_root, np.int32),
            comp_member=np.asarray(comp_member, np.int32),
        )
        # Mode-aware persistence: the artifact holds the discretization
        # (mesh + quadrature) plus ONLY the Step-3 operator family this
        # run's mode needs -- CR face state for the CR default, vertex
        # (dual-Laplacian) state otherwise, neither for greedy.  The cache
        # key stays mode-free (the reference rebuilds only on an hCoef
        # change): a later run in another mode upgrades the SAME artifact
        # in place instead of re-meshing.
        cr_prep = None
        if (surf_ids is not None and options.use_crouzeix_raviart
                and not options.fast_integration):
            from .cr_solver import CRPath

            cr_prep = CRPath.prepare(mesh, surf_ids, np_dtype,
                                     cr_ops=fem.build_cr_operators(mesh))
        H_scipy = None
        vamg = {}
        if cr_prep is None and not options.fast_integration:
            H_scipy, vdev = SignedHeatTetSolver._build_vertex_ops(mesh, np_dtype)
            dev.update(vdev)
            # the vertex path is the default Step 3 here: build (and
            # persist) its hierarchy now, so the solve phase never pays a
            # host AMG setup
            vamg = SignedHeatTetSolver._eager_vamg(H_scipy, mesh, options, np_dtype)
        return dict(
            spacing=float(mesh.mean_node_spacing()),
            mesh=mesh,
            src_labels=labels,
            dev=dev,
            H_csr=(None if H_scipy is None
                   else ell.CSR64.from_scipy(H_scipy)),
            cr=cr_prep,
            cr_face_components=(None if cr_face_components is None
                                else np.asarray(cr_face_components, np.int64)),
            cr_face_areas=(None if cr_face_areas is None
                           else np.asarray(cr_face_areas, np.float64)),
            vamg=vamg,
        )

    @staticmethod
    def _cr_surface_info(mesh: TetMesh, geom, sources):
        """(surf_ids, face_components, face_areas) for the CR path, or
        (None, None, None) when the mesh does not conform to the source."""
        from .cr_solver import find_surface_faces

        if mesh.conforming:
            surf_ids = mesh.surface_faces
            face_labels = surf.connected_components_faces(geom)
            return (surf_ids, face_labels[mesh.surface_parent],
                    mesh.face_areas()[surf_ids])
        # externally-aligned meshes (e.g. lattice-aligned fixtures)
        src_faces_global = mesh.src_vertex[geom.triangles()]
        surf_ids = find_surface_faces(mesh, src_faces_global)
        if surf_ids is None:
            return None, None, None
        return (surf_ids, surf.connected_components_faces(geom),
                sources.weights)

    @staticmethod
    def _build_vertex_ops(mesh: TetMesh, np_dtype):
        """(H_scipy, device-panel dict) for the vertex (dual-Laplacian)
        Step 3, in final dtypes.

        ``H_scipy`` is the RAW operator (the host f64 refinement acts on
        it); the device panels hold the symmetrically EQUILIBRATED operator
        S H S, S = diag(1/sqrt(diag H)), plus the change-of-variable
        vectors ``vscale`` (= diag of S) and ``vnull`` (unit null direction
        of the scaled operator) -- see the comment above _zeroset_solve."""
        dual = fem.build_dual_laplacian(mesh)
        H_scipy = (-dual.to_scipy()).tocsr()  # positive (semi)definite
        s = _vertex_scale(H_scipy)
        Hs = _equilibrated(H_scipy, s)
        diagH = Hs.diagonal()  # ~1 by construction; the guard stays for repair
        diagH = np.where(diagH > 0, diagH, 1.0)
        u = 1.0 / s
        return H_scipy, dict(
            # high-degree vertices skew the dual-Laplacian row widths, so
            # at scale the host form is sliced
            H_ell=(ell.build_sliced(Hs, np_dtype)
                   if Hs.nnz >= amg.SLICED_MIN_NNZ and ell.sliced_waste(Hs) > 1.5
                   else ell.build_ell(Hs, np_dtype)),
            div_rows=np.asarray(dual.div_rows, np.int32),
            div_tets=np.asarray(dual.div_tets, np.int32),
            div_gvec=np.asarray(dual.div_gvec, np_dtype),
            diagH=diagH.astype(np_dtype),
            vscale=s.astype(np_dtype),
            vnull=(u / np.linalg.norm(u)).astype(np_dtype),
        )

    @staticmethod
    def _eager_vamg(H_scipy, mesh: TetMesh, options, np_dtype) -> dict:
        """The (persisted) vertex AMG hierarchy of the run's constraint
        mode; other modes build lazily per process (_hierarchy)."""
        from .cr_solver import PAGED_MIN_NNZ

        mode = options.level_set_constraint
        # hierarchy on the EQUILIBRATED operator, masked after scaling --
        # matching the solve matvec mask*(SHS)(mask x) + (1-mask)x exactly
        Hh = _equilibrated(H_scipy)
        if mode == LevelSetConstraint.ZERO_SET:
            mask = np.ones(Hh.shape[0])
            mask[:mesh.n_src] = 0.0
            Hh = amg.masked_operator(Hh, mask)
        return {mode.value: amg.build_hierarchy_host(
            Hh, np_dtype, skip_level0_A=True,
            # the CR hierarchies' encodings at scale: paged square levels
            # and sliced transfers
            paged_min_nnz=PAGED_MIN_NNZ if np_dtype == np.float32 else None)}

    def _upgrade_artifact(self, cached, options, mutate) -> None:
        """Merge a mode upgrade (vertex operators or CR state built after
        the fact) back into the on-disk artifact, so later processes load
        it instead of rebuilding.  ``mutate(prepared)`` returns True when
        it changed the tree; False (another process already merged this
        family) skips the rewrite.  Best-effort and last-writer-wins:
        concurrent upgrades of DIFFERENT families can drop one of them
        (save_tree replaces the whole directory atomically), costing a
        later re-upgrade, never corruption."""
        key = cached.get("_key")
        if not options.disk_cache or key is None:
            return
        stored = treestore.load_tree(_CACHE_NS + key)
        if stored is None:
            return
        prepared = tree_mod.from_plain(stored)
        if mutate(prepared):
            treestore.save_tree(_CACHE_NS + key, tree_mod.to_plain(prepared))

    def _put_vertex(self, vdev: dict) -> dict:
        """The vertex-path arrays on the solver's device.  ``div_rows``
        goes up as int64 (index_put's index type).  In float32 the operator
        goes up as sliced ELL (pell.SellMat), so every H application -- the
        CG matvec and the V-cycle's level-0 smoothing -- is one launch of
        the sliced-ELL kernel; the host tree keeps the JAX package's
        EllMat / SlicedEll form, which is re-encoded here."""
        vdev = dict(vdev)
        np_dtype = np.asarray(vdev["diagH"]).dtype
        if np_dtype == np.float32:
            n = int(np.asarray(vdev["diagH"]).shape[0])
            vdev["H_ell"] = pell.sell_from_csr(ell.to_scipy(vdev["H_ell"], (n, n)), np_dtype)
        vdev["div_rows"] = np.asarray(vdev["div_rows"], np.int64)
        return ell.device_put_tree(vdev, self.device, self.mesh)

    def _to_device(self, prepared: dict) -> dict:
        """Operator-cache entry from a prepared (possibly memory-mapped)
        tree: scipy wrappers and one device transfer."""
        from .cr_solver import CRPath

        mesh: TetMesh = prepared["mesh"]
        H_scipy = (prepared["H_csr"].to_scipy()
                   if prepared["H_csr"] is not None else None)
        if H_scipy is not None and checks.enabled():
            # the segment-sum assembly must stay symmetric (CG assumes it)
            checks.check_symmetric("tet dual Laplacian",
                                   lambda x: H_scipy @ np.asarray(x), H_scipy.shape[0])
        # the vertex-path operators are dead weight while CR Step 3 is
        # active; an upgraded artifact that carries both families defers
        # the vertex arrays to their first use (_ensure_vertex_ops)
        dev_host = dict(prepared["dev"])
        vertex_host = None
        if "H_ell" in dev_host:
            vertex_host = {k: dev_host.pop(k) for k in self.VERTEX_KEYS}
        cached = dict(
            mesh=mesh,
            cr_path=(None if prepared["cr"] is None else
                     CRPath(mesh, device=self.device, prepared=prepared["cr"],
                            device_mesh=self.mesh)),
            cr_face_components=prepared["cr_face_components"],
            cr_face_areas=prepared["cr_face_areas"],
            spacing=float(prepared["spacing"]),
            src_labels=np.asarray(prepared["src_labels"], dtype=np.int64),
            src_vertex=torch.as_tensor(np.asarray(mesh.src_vertex, np.int64),
                                       device=self.device),
            H_scipy=H_scipy,
            # per-constraint-mode hierarchies (+ lazy builds)
            amg={LevelSetConstraint(k): amg.hierarchy_to_device(h, self.device, self.mesh)
                 for k, h in prepared["vamg"].items()},
            _vertex_host=None,
            **ell.device_put_tree(dev_host, self.device),
        )
        if vertex_host is not None and prepared["cr"] is not None:
            cached["_vertex_host"] = vertex_host
        elif vertex_host is not None:
            cached.update(self._put_vertex(vertex_host))
        return cached

    def _ensure_vertex_ops(self, cached, options):
        """Make the vertex-path operators device-resident on first use
        (``use_crouzeix_raviart=False`` or a failed CR on a CR-keyed
        artifact):

        1. already resident -> no-op;
        2. persisted but deferred (an artifact with both families) -> ship;
        3. absent from a lean mode-aware artifact -> BUILD from the cached
           mesh now and merge the upgrade back into the disk artifact, so
           later processes skip the rebuild."""
        if "H_ell" in cached:
            return
        # every vertex graph reads the operators replaced below
        cached.pop("vertex_graphs", None)
        if cached.get("_vertex_host") is not None:
            cached.update(self._put_vertex(cached.pop("_vertex_host")))
            return
        mesh: TetMesh = cached["mesh"]
        np_dtype = np.dtype(options.dtype)
        H_scipy, vdev = SignedHeatTetSolver._build_vertex_ops(mesh, np_dtype)
        cached["H_scipy"] = H_scipy
        cached.update(self._put_vertex(vdev))
        # build (and persist) the current mode's hierarchy with the
        # encodings the eager path uses
        vamg = SignedHeatTetSolver._eager_vamg(H_scipy, mesh, options, np_dtype)
        for k, h in vamg.items():
            cached["amg"][LevelSetConstraint(k)] = amg.hierarchy_to_device(
                h, self.device, self.mesh)

        def mutate(prepared):
            if prepared.get("H_csr") is not None:
                return False
            prepared["dev"] = {**prepared["dev"], **vdev}
            prepared["H_csr"] = ell.CSR64.from_scipy(H_scipy)
            prepared["vamg"] = dict(vamg)
            return True

        self._upgrade_artifact(cached, options, mutate)

    def _ensure_cr_path(self, cached, geom, options):
        """Build the CR face state on a vertex- or greedy-keyed artifact
        when a CR-mode solve arrives, and merge it into the disk artifact.
        No-op when the mesh cannot support CR."""
        if cached.get("cr_path") is not None or cached.get("_cr_unsupported"):
            return
        mesh: TetMesh = cached["mesh"]
        if not (isinstance(geom, Mesh) and geom.is_triangular):
            cached["_cr_unsupported"] = True
            return
        sources = src_mod.from_geometry(geom)
        surf_ids, comps, areas = SignedHeatTetSolver._cr_surface_info(
            mesh, geom, sources)
        if surf_ids is None:
            cached["_cr_unsupported"] = True
            return
        from .cr_solver import CRPath

        cr_prep = CRPath.prepare(mesh, surf_ids, np.dtype(options.dtype),
                                 cr_ops=fem.build_cr_operators(mesh))
        cached["cr_path"] = CRPath(mesh, device=self.device, prepared=cr_prep,
                                   device_mesh=self.mesh)
        cached["cr_face_components"] = np.asarray(comps, np.int64)
        cached["cr_face_areas"] = np.asarray(areas, np.float64)

        def mutate(prepared):
            if prepared.get("cr") is not None:
                return False
            prepared["cr"] = cr_prep
            prepared["cr_face_components"] = cached["cr_face_components"]
            prepared["cr_face_areas"] = cached["cr_face_areas"]
            return True

        self._upgrade_artifact(cached, options, mutate)

    def _hierarchy(self, cached, mode, n_src: int, np_dtype):
        """Per-mode SA-AMG hierarchy for the vertex solves (the run's first
        mode is persisted by _prepare_host, others build lazily per
        process)."""
        if mode not in cached["amg"]:
            H = _equilibrated(cached["H_scipy"])
            if mode == LevelSetConstraint.ZERO_SET:
                mask = np.ones(H.shape[0])
                mask[:n_src] = 0.0
                H = amg.masked_operator(H, mask)
            cached["amg"][mode] = amg.hierarchy_to_device(
                amg.build_hierarchy_host(H, np_dtype, skip_level0_A=True),
                self.device, self.mesh)
        return cached["amg"][mode]

    def _integrate(self, Y, mesh, cached, options, tm):
        if "H_ell" not in cached and cached.get("_vertex_host") is None:
            tm.note("vertex operators absent from artifact: building "
                    "(mode upgrade; merged back to disk)")
        self._ensure_vertex_ops(cached, options)
        n = mesh.n_vertices
        mode = options.level_set_constraint
        tol, maxiter = options.resolved_solver_tol(), options.solver_maxiter
        div = _divergence(Y, cached["div_rows"], cached["div_tets"],
                          cached["div_gvec"], n)
        dtype = div.dtype
        H, diagH = cached["H_ell"], cached["diagH"]
        h = self._hierarchy(cached, mode, mesh.n_src, np.dtype(options.dtype))
        solve_stats: dict = {}
        refine_stats: dict = {}
        H64 = cached["H_scipy"]
        # device solves run in equilibrated variables (the comment above
        # _zeroset_solve): scale the rhs into them, unscale the solution
        # out; the host f64 refinement operators below stay in ORIGINAL
        # variables (run() presents an original-variable solve to
        # _refined_solve)
        vs = cached["vscale"]
        div64 = div.cpu().numpy().astype(np.float64)
        zeros = torch.zeros(n, dtype=dtype, device=self.device)
        # the mode's iteration graph, beside the operator and hierarchy it
        # reads (dropped by _ensure_vertex_ops when it replaces them); on a
        # device mesh the row-split solves run eagerly
        graph = (None if self.mesh is not None
                 else (cached.setdefault("vertex_graphs", {}), (mode, dtype)))

        def scaled_run(solve_of):
            def run(b, tol=tol, maxiter=maxiter):
                bs = vs * b
                y, iters, res = _run_chunked(
                    lambda x0, it: solve_of(bs, x0, tol, it),
                    zeros, maxiter, stats=solve_stats)
                return vs * y, iters, res
            return run

        refined = lambda run, host_op, b64: _refined_solve(
            run, host_op, b64, dtype, self.device, options, tm, stats=refine_stats)
        if mode == LevelSetConstraint.ZERO_SET:
            mask64 = np.ones(n)
            mask64[:mesh.n_src] = 0.0
            mask = torch.as_tensor(mask64, dtype=dtype, device=self.device)
            b64 = mask64 * -div64
            host_op = lambda x: mask64 * (H64 @ (mask64 * x)) + (1.0 - mask64) * x
            run = scaled_run(lambda bs, x0, t, it: _zeroset_solve(
                bs, x0, H, diagH, mask, h, t, it, graph))
            phi, iters, res = refined(run, host_op, b64)
            phi = torch.as_tensor(phi, dtype=dtype, device=self.device)
        elif mode == LevelSetConstraint.MULTIPLE:
            sv = np.asarray(mesh.src_vertex)
            first = np.sort(np.unique(sv, return_index=True)[1])
            elems = sv[first]
            _, gids = np.unique(cached["src_labels"][first], return_inverse=True)
            sizes = np.bincount(gids).astype(np.float64)
            n_groups = int(gids.max()) + 1
            # scaled-space group projection weights: u = sqrt(diag H) at the
            # component vertices (see _multiple_solve)
            u64 = 1.0 / _vertex_scale(H64)
            ue = u64[elems]
            uinv = 1.0 / np.bincount(gids, weights=ue ** 2, minlength=n_groups)
            put = lambda a, dt: torch.as_tensor(a, dtype=dt, device=self.device)
            g_elems, g_ids = put(elems, torch.int64), put(gids, torch.int64)
            g_u, g_uinv = put(ue, dtype), put(uinv, dtype)

            def proj64(v):
                v = np.array(v, copy=True)
                sums = np.bincount(gids, weights=v[elems], minlength=n_groups)
                v[elems] = (sums / sizes)[gids]
                return v - v.mean()

            b64 = proj64(-div64)
            host_op = lambda x: proj64(H64 @ x)
            run = scaled_run(lambda bs, x0, t, it: _multiple_solve(
                bs, x0, H, diagH, g_elems, g_ids, g_u, g_uinv, cached["vnull"],
                n_groups, h, t, it, graph))
            x, iters, res = refined(run, host_op, b64)
            phi = self._shift(torch.as_tensor(x, dtype=dtype, device=self.device),
                              cached)
        else:
            b64 = -div64
            b64 = b64 - b64.mean()
            host_op = lambda x: (lambda y: y - y.mean())(H64 @ x)
            run = scaled_run(lambda bs, x0, t, it: _none_solve(
                bs, x0, H, diagH, cached["vnull"], h, t, it, graph))
            phi, iters, res = refined(run, host_op, b64)
            phi = self._shift(torch.as_tensor(phi, dtype=dtype, device=self.device),
                              cached)
        tm.note(f"krylov iters={int(iters)} rel_res={float(res):.2e}")
        self.last_stats.update(
            iters=int(iters), rel_res=float(res), residual=float(res),
            chunks=solve_stats.get("chunks", []),
            amg_sizes=list(h.sizes),
            refine_pass_rels=refine_stats.get("refine_pass_rels", []))
        return phi.cpu().numpy()

    def _shift(self, phi: torch.Tensor, cached) -> torch.Tensor:
        """phi minus its dual-area-weighted mean over the source vertices."""
        w = cached["dual_areas"].to(phi.dtype)
        vals = phi.index_select(0, cached["src_vertex"])
        return phi - torch.sum(w * vals) / torch.sum(w)

    def _greedy(self, mesh, Y, cached, options):
        mode = options.level_set_constraint
        if mode == LevelSetConstraint.ZERO_SET:
            seeds = np.unique(mesh.src_vertex)
            phi = integrate_greedily_tet(mesh, Y, seeds)
        elif mode == LevelSetConstraint.MULTIPLE:
            phi = self._greedy_multi(mesh, Y, cached)
        else:
            phi = integrate_greedily_tet(mesh, Y, np.array([0]))
            phi = self._shift(torch.as_tensor(phi, dtype=torch.float64,
                                              device=self.device), cached).cpu().numpy()
        return phi

    def _greedy_multi(self, mesh: TetMesh, Y: np.ndarray, cached) -> np.ndarray:
        """BFS from vertex 0; the first time a component is reached its
        value is locked and later member vertices copy it."""
        NV = mesh.n_vertices
        comp_of = np.full(NV, -1, dtype=np.int64)
        # true per-input-vertex component labels cached at build time
        # (singleton components keep their own distinct label)
        src_labels = np.asarray(cached["src_labels"], dtype=np.int64)
        comp_of[np.asarray(mesh.src_vertex)] = src_labels
        n_comp = int(src_labels.max()) + 1 if src_labels.size else 1
        comp_value = np.zeros(n_comp)
        comp_visited = np.zeros(n_comp, dtype=bool)

        phi = np.zeros(NV)
        visited = np.zeros(NV, dtype=bool)
        visited[0] = True
        if comp_of[0] >= 0:
            comp_visited[comp_of[0]] = True
        queue = collections.deque([0])
        verts, tets = mesh.vertices, mesh.tets
        indptr, data = mesh.vt_indptr, mesh.vt_data
        V = mesh.n_src
        while queue:
            curr = queue.popleft()
            p = verts[curr]
            for tid in data[indptr[curr]:indptr[curr + 1]]:
                for nb in tets[tid]:
                    if visited[nb]:
                        continue
                    cb = comp_of[nb] if nb < V else -1
                    if cb >= 0 and comp_visited[cb]:
                        phi[nb] = comp_value[cb]
                    else:
                        phi[nb] = phi[curr] + float(np.dot(Y[tid], verts[nb] - p))
                        if cb >= 0:
                            comp_visited[cb] = True
                            comp_value[cb] = phi[nb]
                    visited[nb] = True
                    queue.append(int(nb))
        return phi


def _canonical(device) -> torch.device:
    """``device`` with the current card's index where "cuda" names none."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def solve_tet(geom, options: SignedHeatOptions = SignedHeatOptions(),
              device="cuda") -> TetResult:
    return SignedHeatTetSolver(device=device).compute_distance(geom, options)
