"""Tet-domain solver (port of the Crouzeix-Raviart path of
shm3d.tet.solver).

  host:   conforming tet domain + CR operators + AMG hierarchy
          (NumPy/SciPy, the JAX package's code; cached in memory and on disk)
  device: Yukawa kernel at tet barycenters -> face divergence -> CR face
          solve (AMG-CG over the paged face operator) -> L2 projection onto
          the vertices, each solve with host f64 defect correction

Outside this port so far (each raises NotImplementedError naming its ROADMAP
item): the vertex (dual-Laplacian) path -- point clouds, polygon meshes,
``use_crouzeix_raviart=False`` and meshes whose conforming recovery failed
(A14); greedy ``fast_integration`` (A17); a device mesh (A16).
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Optional

import numpy as np
import torch

from ..config import SignedHeatOptions
from ..geometry import sources as src_mod
from ..geometry import surface as surf
from ..io.mesh_io import Mesh
from . import fem
from .mesher import MESHER_VERSION, TetMesh, build_tet_domain
from ..utils import diskcache, treestore

from .._device import resolve_device, torch_dtype
from .._inputs import check_inputs
from ..ops.yukawa import yukawa_field
from ..solve import ell
from ..utils import tree as tree_mod
from ..utils.timing import PhaseTimer

# disk-cache namespace of the port's prepared tet artifacts, apart from the
# JAX package's ("tetprep", ...) so the two never read each other's trees
_CACHE_NS = ("tetprep_torch", "c1")


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


def _vertex_path_error(why: str) -> NotImplementedError:
    return NotImplementedError(
        f"{why}: takes the tet vertex (dual-Laplacian) path, not ported yet "
        "(ROADMAP A14); the port runs the Crouzeix-Raviart path of "
        "conforming triangle meshes")


def _check_options(geom, options: SignedHeatOptions) -> None:
    if options.fast_integration:
        raise NotImplementedError(
            "fast_integration=True (greedy BFS integration) on the tet "
            "domain is not ported yet (ROADMAP A17)")
    if not isinstance(geom, Mesh):
        raise _vertex_path_error("a point cloud")
    if not geom.is_triangular:
        raise _vertex_path_error("a polygon mesh")
    if not options.use_crouzeix_raviart:
        raise _vertex_path_error("use_crouzeix_raviart=False")


class SignedHeatTetSolver:
    """Stateful tet solver with the reference caching contract: the
    discretization and operators of a geometry are built once per
    (geometry, options cache key) and reused by later solves.

    ``device`` is required to exist: "cuda" without a visible card raises,
    and nothing falls back to the CPU.  ``mesh`` (a device mesh for
    multi-device solves) is not ported."""

    def __init__(self, device="cuda", mesh=None):
        if mesh is not None:
            raise NotImplementedError(
                "multi-device tet solves (a device mesh) are not ported yet "
                "(ROADMAP A16)")
        self.device = resolve_device(device)
        self._cache = {}
        self.last_stats = {}

    def compute_distance(self, geom, options: SignedHeatOptions = SignedHeatOptions()) -> TetResult:
        check_inputs(geom, options)
        _check_options(geom, options)
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
                self._cache[key] = cached
        mesh: TetMesh = cached["mesh"]
        if cached["cr_path"] is None:
            raise _vertex_path_error(
                "the tet mesh does not conform to the surface (conforming "
                "recovery failed or conforming=False)")

        lam = math.sqrt(1.0 / (options.t_coef * cached["spacing"] ** 2))

        with tm.phase("steps 1&2 (Yukawa at tet barycenters)"):
            Y = yukawa_field(cached["barys"], cached["points"], cached["vectors"], lam)

        self.last_stats["step3_path"] = "crouzeix-raviart"
        with tm.phase("step 3 (Crouzeix-Raviart face solve)"):
            phi = cached["cr_path"].integrate(
                Y, options,
                src_face_components=cached["cr_face_components"],
                src_face_areas=cached["cr_face_areas"],
            )
        self.last_stats.update(cached["cr_path"].last_stats)

        phi_host = np.asarray(phi, dtype=np.float64)
        self.last_stats["phases"] = tm.as_dict()
        if self.device.type == "cuda":
            self.last_stats["mem_peak_mb"] = (
                torch.cuda.max_memory_allocated(self.device) / 1e6)
        return TetResult(phi_host, mesh, Y.cpu().numpy().astype(np.float64))

    # -- internals

    def _prepare_host(self, geom, options) -> dict:
        """Host precompute as a numpy-leaf tree: the conforming tet domain,
        source quadrature, and the CR path preparation
        (cr_solver.CRPath.prepare), everything in final dtypes.  ``cr`` is
        None when the mesh does not conform to the surface."""
        from .cr_solver import CRPath

        np_dtype = np.dtype(options.dtype)
        sources = src_mod.from_geometry(geom)
        mean_area = float(np.mean(sources.weights))
        # the option is honored on both domains (the reference's tet path
        # always meshes with scale=2)
        src_faces = geom.triangles() if options.conforming else None
        mesh = build_tet_domain(geom.vertices, options.scale, options.h_coef,
                                mean_area=mean_area, src_faces=src_faces)
        surf_ids, cr_face_components, cr_face_areas = \
            SignedHeatTetSolver._cr_surface_info(mesh, geom, sources)
        cr_prep = None
        if surf_ids is not None:
            cr_prep = CRPath.prepare(mesh, surf_ids, np_dtype,
                                     cr_ops=fem.build_cr_operators(mesh))
        return dict(
            spacing=float(mesh.mean_node_spacing()),
            mesh=mesh,
            dev=dict(
                barys=np.asarray(mesh.barycenters(), np_dtype),
                points=np.asarray(sources.points, np_dtype),
                vectors=np.asarray(sources.vectors(), np_dtype),
            ),
            cr=cr_prep,
            cr_face_components=(None if cr_face_components is None
                                else np.asarray(cr_face_components, np.int64)),
            cr_face_areas=(None if cr_face_areas is None
                           else np.asarray(cr_face_areas, np.float64)),
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

    def _to_device(self, prepared: dict) -> dict:
        """Operator-cache entry: Step-1 arrays and the CR path on the
        solver's device."""
        from .cr_solver import CRPath

        mesh: TetMesh = prepared["mesh"]
        cr_path = None
        if prepared["cr"] is not None:
            cr_path = CRPath(mesh, device=self.device, prepared=prepared["cr"])
        return dict(
            mesh=mesh,
            cr_path=cr_path,
            cr_face_components=prepared["cr_face_components"],
            cr_face_areas=prepared["cr_face_areas"],
            spacing=float(prepared["spacing"]),
            **ell.device_put_tree(dict(prepared["dev"]), self.device),
        )
