"""Grid-domain solver: the device pipeline on a regular grid (port of the
fast tier of shm3d.solvers.grid).

  host:   sources + grid spec + trilinear constraint rows + Gram artifacts
          (NumPy, cached in memory and on disk)
  device: Yukawa kernel (dense or shell) -> adjoint divergence ->
          projected pin-aware MG-PCG -> mean shift

The always-on zero-set pinning (KKT [[L, A^T], [A, 0]], phi = -u) is solved
with the null-space method: multigrid-preconditioned CG on
P H P u = P b, H = -L (shm3d_torch.solve.projection).

Outside this port so far (each raises NotImplementedError naming its ROADMAP
item): float64 defect correction (``refine_steps > 0`` with float32), fast
integration, the MINRES-on-KKT method, and the subsampled-pin and
host-projected tiers taken past ORTHO_GRAM_CAP in float64 or past
TFORM_FULL_CAP.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from shm3d.config import SignedHeatOptions
from shm3d.domains import grid as griddom
from shm3d.geometry import sources as src_mod
from shm3d.io.mesh_io import Mesh
from shm3d.utils import diskcache

from .._device import resolve_device, torch_dtype
from ..ops import farfield, stencil
from ..ops.yukawa import yukawa_field
from ..solve import krylov, multigrid, projection
from ..utils.timing import PhaseTimer

# disk-cache namespaces: the artifact format of shm3d ("g2"), under keys of
# its own so the two packages never read each other's entries
_CACHE_NS = ("grid_torch", "g2")
_SHELL_CACHE_NS = ("grid_torch_shell",)


class GridResult:
    """Solve result: ``phi_device`` is the (N,) tensor on the solver's
    device (flat node order), ``phi`` a float64 host copy made on first
    access."""

    def __init__(self, phi_dev: torch.Tensor, grid: griddom.GridSpec,
                 Y: Optional[torch.Tensor] = None,
                 u_dev: Optional[torch.Tensor] = None):
        self._phi_dev = phi_dev
        self._phi_host: Optional[np.ndarray] = None
        self.grid = grid
        self.Y = Y              # (N, 3) normalized Step-2 field
        self.u_device = u_dev   # (N,) primal solution before phi = -u + shift

    @property
    def phi(self) -> np.ndarray:
        if self._phi_host is None:
            self._phi_host = self._phi_dev.detach().cpu().numpy().astype(np.float64)
        return self._phi_host

    @property
    def phi_device(self) -> torch.Tensor:
        return self._phi_dev

    def phi3(self) -> np.ndarray:
        return self.phi.reshape(self.grid.shape)


def _node_positions_device(bbox_min, cell_size: float, n: int, dtype, device):
    """(n^3, 3) node positions in flat order i + j*n + k*n^2."""
    r = torch.arange(n, dtype=dtype, device=device) * cell_size
    z, y, x = torch.meshgrid(r, r, r, indexing="ij")
    pos = torch.stack([x, y, z], dim=-1).reshape(-1, 3)
    return pos + torch.as_tensor(bbox_min, dtype=dtype, device=device)[None, :]


def _rhs_div(Y: torch.Tensor, cell_size: float, shape, guard_nans: bool) -> torch.Tensor:
    """Adjoint divergence of the normalized field; on meshes the NaN rows of
    a node coincident with a source are zeroed (as the reference does)."""
    div = stencil.divergence_apply(Y.reshape(*shape, 3), cell_size).reshape(-1)
    if guard_nans:
        div = torch.where(torch.isfinite(div), div, torch.zeros_like(div))
    return div


def _solve_pinned(b, nodes8, coeffs8, gram, cell_size: float, shape, tol: float,
                  maxiter: int, pins=None):
    """Projected MG-PCG on P H P u = P b in one run (no restarts).  Returns
    (u, iterations, relative preconditioned residual) with u in ker(A).
    Both the matvec and the preconditioner project: MG applied to an
    unprojected residual builds wrong search directions."""
    N = b.shape[0]
    proj = projection.make_projector(nodes8, coeffs8, gram, N)
    mg = multigrid.make_node_preconditioner(shape, cell_size, pins=pins)

    def matvec(u):
        # u stays in ker(A) along the recurrence, so P H P u = P (H u)
        return proj(-stencil.laplacian_apply(u.reshape(shape), cell_size).reshape(-1))

    def precond(r):
        return proj(mg(r))

    Pb = proj(b)
    rhs_mnorm = math.sqrt(abs(float(torch.dot(Pb, precond(Pb)))))
    res = krylov.cg(matvec, Pb, precond=precond, tol=tol, maxiter=maxiter,
                    rhs_mnorm=rhs_mnorm, stall_window=60)
    rel = res.residual / max(rhs_mnorm, torch.finfo(b.dtype).tiny)
    return res.x, res.iterations, rel


def _mean_shift(phi, src_nodes8, src_coeffs8, weights):
    """Subtract the weighted average of the trilinear interpolant along the
    source."""
    vals = (phi[src_nodes8] * src_coeffs8).sum(dim=1)
    return phi - (weights * vals).sum() / weights.sum()


def _check_options(options: SignedHeatOptions) -> None:
    if options.fast_integration:
        raise NotImplementedError(
            "fast_integration=True (greedy integration) is not ported yet "
            "(ROADMAP A12)")
    if options.solver_method != "projected_cg":
        raise NotImplementedError(
            f"solver_method={options.solver_method!r} is not ported: the "
            "port runs projected_cg and leaves the MINRES-on-KKT comparison "
            "path behind (ROADMAP, 'What the port leaves behind')")
    if options.refine_steps > 0 and options.dtype == "float32":
        raise NotImplementedError(
            "refine_steps > 0 (float64 defect correction of the float32 "
            "solve) is not ported yet (ROADMAP A11); pass refine_steps=0")


def cached_from_arrays(arrays: dict, device, dtype: torch.dtype) -> dict:
    """Device operator-cache entry from the host arrays of
    ``GridSolver._build_host_arrays`` (either package: the format is the
    same)."""
    if arrays.get("pin_keep") is not None:
        raise NotImplementedError(
            "subsampled-pin tier artifacts are not ported yet (ROADMAP A10)")
    grid = griddom.GridSpec(
        bbox_min=tuple(np.asarray(arrays["grid_bbox_min"], np.float64)),
        cell_size=float(arrays["grid_cell"]),
        n=int(arrays["grid_n"]),
    )
    gram_arrays = {
        k[len("gram_"):]: v for k, v in arrays.items() if k.startswith("gram_")
    }
    if gram_arrays.get("bmat") is None and gram_arrays.get("tform_eps") is None:
        raise NotImplementedError(
            "host-projected tier (no bmat, no full-row factor) is not ported "
            "yet (ROADMAP A10)")

    def dev(a, dt):
        return torch.as_tensor(np.asarray(a), device=device).to(dt)

    return dict(
        grid=grid,
        spacing=float(arrays["spacing"]),
        nodes8=dev(arrays["nodes8"], torch.int64),
        coeffs8=dev(arrays["coeffs8"], dtype),
        gram=projection.gram_from_arrays(gram_arrays, device, dtype),
        src_nodes8=dev(arrays["src_nodes8"], torch.int64),
        src_coeffs8=dev(arrays["src_coeffs8"], dtype),
        points=dev(arrays["points"], dtype),
        vectors=dev(arrays["vectors"], dtype),
        weights=dev(arrays["weights"], dtype),
    )


class GridSolver:
    """Stateful grid solver with the reference caching contract: the
    discretization of a geometry is built once per (geometry, options
    cache key) and reused by later solves.

    ``device`` is required to exist: "cuda" without a visible card raises,
    and nothing falls back to the CPU."""

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self._cache = {}
        self.last_stats = {}

    def compute_distance(self, geom, options: SignedHeatOptions = SignedHeatOptions()) -> GridResult:
        _check_options(options)
        dtype = torch_dtype(options.dtype)
        tm = PhaseTimer(self.device, verbose=options.verbose)
        is_mesh = isinstance(geom, Mesh)
        tol = options.resolved_solver_tol()
        self.last_stats = {}
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)

        with tm.phase("precompute (sources + grid + constraints)"):
            key = (diskcache.geometry_content_hash(geom), options.cache_key())
            cached = self._cache.get(key)
            if cached is None:
                arrays = (diskcache.load(_CACHE_NS + key)
                          if options.disk_cache else None)
                if arrays is not None:
                    tm.note("operator cache: disk hit")
                else:
                    arrays = self._build_host_arrays(geom, options)
                    if options.disk_cache:
                        diskcache.save(_CACHE_NS + key, arrays)
                cached = cached_from_arrays(arrays, self.device, dtype)
                self._cache[key] = cached
            grid = cached["grid"]

        lam = math.sqrt(1.0 / (options.t_coef * cached["spacing"] ** 2))
        cell = float(grid.cell_size)

        with tm.phase("steps 1&2 (Yukawa convolution + normalize)"):
            use_shell = (
                options.step1_method == "shell"
                or (options.step1_method == "auto" and grid.n >= options.shell_auto_n)
            )
            if use_shell:
                plan = self._shell_plan(cached, key, lam, options)
                tm.note(f"shell decomposition: {plan.shell_fraction:.1%} exact "
                        f"nodes + {plan.m}^3 coarse lattice")
                self.last_stats["shell_nodes"] = int(plan.shell_idx.shape[0])
                self.last_stats["coarse_nodes"] = int(plan.coarse_pos.shape[0])
                Y = farfield.yukawa_field_shell(
                    plan, cached["points"], cached["vectors"], lam, grid.n)
            else:
                queries = cached.get("queries")
                if queries is None:
                    queries = _node_positions_device(
                        grid.bbox_min, cell, grid.n, dtype, self.device)
                    cached["queries"] = queries
                Y = yukawa_field(queries, cached["points"], cached["vectors"], lam)

        self.last_stats["step3_path"] = "projected-mg-pcg"
        with tm.phase("step 3 (divergence + projected MG-PCG solve)"):
            b = -_rhs_div(Y, cell, grid.shape, is_mesh)
            pins = cached.get("pin_masks")
            if pins is None:
                pins = multigrid.build_pin_masks(cached["nodes8"], grid.shape, dtype)
                cached["pin_masks"] = pins
            u, iters, resid = _solve_pinned(
                b, cached["nodes8"], cached["coeffs8"], cached["gram"], cell,
                grid.shape, tol, options.solver_maxiter, pins=pins)
            tm.note(f"projected_cg iters={iters} rel_res={resid:.2e}")
            self.last_stats["iters"] = iters
            self.last_stats["rel_res"] = resid

        with tm.phase("mean shift along source"):
            phi = _mean_shift(-u, cached["src_nodes8"], cached["src_coeffs8"],
                              cached["weights"])

        self.last_stats["phases"] = tm.as_dict()
        self.last_stats["tform_eps"] = cached["gram"].tform_eps
        if self.device.type == "cuda":
            self.last_stats["mem_peak_mb"] = (
                torch.cuda.max_memory_allocated(self.device) / 1e6)
        return GridResult(phi, grid, Y, u_dev=u)

    def _shell_plan(self, cached, key, lam: float, options) -> farfield.DeviceShellPlan:
        plan_key = ("shell_plan", "v2", lam, options.shell_t,
                    options.shell_coarse_factor)
        plan = cached.get(plan_key)
        if plan is not None:
            return plan
        arrays = (diskcache.load(_SHELL_CACHE_NS + key + plan_key)
                  if options.disk_cache else None)
        if arrays is None:
            # the EDT sees the sources as the compute dtype holds them
            points = cached["points"].cpu().numpy().astype(np.float64)
            arrays = farfield.build_shell_plan(
                cached["grid"], points, lam, options.shell_t,
                options.shell_coarse_factor).arrays()
            if options.disk_cache:
                diskcache.save(_SHELL_CACHE_NS + key + plan_key, arrays)
        plan = farfield.DeviceShellPlan.from_arrays(
            arrays, self.device, cached["points"].dtype)
        cached[plan_key] = plan
        return plan

    def _build_host_arrays(self, geom, options: SignedHeatOptions) -> dict:
        """Host precompute as plain numpy arrays (the serializable operator
        cache artifact, the format of shm3d.solvers.grid): source
        quadrature, grid spec, constraint and source trilinear rows, Gram
        projection artifacts of the bmat or full-row tier."""
        is_mesh = isinstance(geom, Mesh)
        sources = self._sources(geom)
        seed_pts = geom.vertices if is_mesh else geom.positions
        grid = griddom.build_grid(seed_pts, options.scale, options.h_coef)
        nodes8, coeffs8 = griddom.constraint_rows(grid, sources.points)
        src_nodes8, src_coeffs8 = griddom.trilinear_rows(grid, sources.points)
        m = nodes8.shape[0]
        if m <= projection.ORTHO_GRAM_CAP:
            gram_arrays = projection.build_gram_arrays(
                nodes8, coeffs8, grid.total_nodes, options.dtype)
        elif (options.max_device_pins is not None and options.dtype == "float32"
                and m <= projection.TFORM_FULL_CAP):
            # full-row whitening tier: the factor of all m rows is built on
            # the device at load (gram_from_arrays)
            gram_arrays = projection.build_tform_full_arrays(
                nodes8, coeffs8, grid.total_nodes)
        else:
            raise NotImplementedError(
                f"m={m} constraint rows with dtype={options.dtype} and "
                f"max_device_pins={options.max_device_pins} takes the "
                "subsampled-pin or host-projected tier, not ported yet "
                "(ROADMAP A10)")
        arrays = dict(
            grid_bbox_min=np.asarray(grid.bbox_min, np.float64),
            grid_cell=np.float64(grid.cell_size),
            grid_n=np.int64(grid.n),
            spacing=np.float64(sources.spacing),
            nodes8=nodes8.astype(np.int32),
            coeffs8=np.asarray(coeffs8, np.float64),
            src_nodes8=src_nodes8.astype(np.int32),
            src_coeffs8=np.asarray(src_coeffs8, np.float64),
            points=np.asarray(sources.points, np.float64),
            vectors=np.asarray(sources.vectors(), np.float64),
            weights=np.asarray(sources.weights, np.float64),
        )
        for k, v in gram_arrays.items():
            arrays["gram_" + k] = v
        return arrays

    @staticmethod
    def _sources(geom) -> src_mod.SourceDistribution:
        """Source quadrature, memoized on the geometry object (the attribute
        name is shared with shm3d, so one computation serves both)."""
        cached = getattr(geom, "_shm3d_sources", None)
        if cached is None:
            cached = src_mod.from_geometry(geom)
            try:
                setattr(geom, "_shm3d_sources", cached)
            except AttributeError:
                pass
        return cached
