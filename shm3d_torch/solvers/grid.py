"""Grid-domain solver: the device pipeline on a regular grid (port of the
fast and default tiers of shm3d.solvers.grid).

  host:   sources + grid spec + trilinear constraint rows + Gram artifacts
          (NumPy, cached in memory and on disk)
  device: Yukawa kernel (dense or shell) -> adjoint divergence ->
          projected pin-aware MG-PCG -> [float64 defect correction] ->
          mean shift

The always-on zero-set pinning (KKT [[L, A^T], [A, 0]], phi = -u) is solved
with the null-space method: multigrid-preconditioned CG on
P H P u = P b, H = -L (shm3d_torch.solve.projection).

The default tier (``refine_steps > 0`` with float32) corrects the float32
solve with exact float64 residuals of the projected system: on the device in
native float64 (``refine_mode="pair"``, the default; the JAX package's
two-float arithmetic answers the TPU's lack of float64) or in host NumPy
(``refine_mode="host"``).  Either way the (m, m) Gram solve of the
projection runs on the host (splu) and each correction is a float32
projected MG-PCG solve.

Outside this port so far (each raises NotImplementedError naming its ROADMAP
item): fast integration, the MINRES-on-KKT method, and the subsampled-pin
and host-projected tiers taken past ORTHO_GRAM_CAP in float64 or past
TFORM_FULL_CAP.
"""

from __future__ import annotations

import math
import time
import warnings
from typing import Optional

import numpy as np
import torch

from ..config import SignedHeatOptions
from ..domains import grid as griddom
from ..geometry import sources as src_mod
from ..io.mesh_io import Mesh
from ..utils import diskcache

from .._device import resolve_device, synchronize, torch_dtype
from .._inputs import check_inputs
from ..ops import farfield, stencil
from ..ops.yukawa import yukawa_field
from ..solve import krylov, multigrid, projection
from ..utils.timing import PhaseTimer

# disk-cache namespaces: the artifact format of shm3d ("g2"), under keys of
# its own so the two packages never read each other's entries
_CACHE_NS = ("grid_torch", "g2")
_SHELL_CACHE_NS = ("grid_torch_shell",)

# copied from shm3d/solvers/grid.py: above this many grid nodes the float32
# solve is returned without the float64 defect correction
REFINE_MAX_NODES = 100_000_000


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


def _solve_pinned(b, nodes8, coeffs8, gram, at, cell_size: float, shape, tol: float,
                  maxiter: int, pins=None):
    """Projected MG-PCG on P H P u = P b in one run (no restarts).  Returns
    (u, iterations, relative preconditioned residual) with u in ker(A).
    Both the matvec and the preconditioner project: MG applied to an
    unprojected residual builds wrong search directions."""
    N = b.shape[0]
    proj = projection.make_projector(nodes8, coeffs8, gram, N, at)
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


# copied from shm3d/solvers/grid.py (_laplacian_apply_np, _div64_np): the
# host float64 mirrors of the device stencils for refine_mode="host"
def _laplacian_apply_np(u3: np.ndarray, cell: float) -> np.ndarray:
    acc = -6.0 * u3
    for axis in range(3):

        def shift(arr, d):
            pad = [(0, 0)] * 3
            pad[axis] = (1, 0) if d < 0 else (0, 1)
            padded = np.pad(arr, pad, mode="edge")
            sl = [slice(None)] * 3
            sl[axis] = slice(1, None) if d > 0 else slice(0, -1)
            return padded[tuple(sl)]

        acc = acc + shift(u3, +1) + shift(u3, -1)
    return acc / (cell * cell)


def _div64_np(Y64: np.ndarray, cell: float) -> np.ndarray:
    """NumPy f64 adjoint divergence."""
    shape = Y64.shape[:3]
    out = np.zeros(shape)
    comp_axis = {0: 2, 1: 1, 2: 0}
    for comp in range(3):
        axis = comp_axis[comp]
        g = Y64[..., comp] / cell
        n = shape[axis]
        sl = lambda a, b: tuple(
            slice(a, b) if ax == axis else slice(None) for ax in range(3)
        )
        # adjoint of: out[i] = u[i+1] - u[i] (i < n-1); out[n-1] = u[n-1] - u[n-2]
        acc = np.zeros(shape)
        sub = np.zeros(shape)
        acc[sl(1, n)] += g[sl(0, n - 1)]
        sub[sl(0, n - 1)] += g[sl(0, n - 1)]
        acc[sl(n - 1, n)] += g[sl(n - 1, n)]
        sub[sl(n - 2, n - 1)] += g[sl(n - 1, n)]
        out += acc - sub
    return out.reshape(-1)


def project_f64(v: torch.Tensor, nodes8: torch.Tensor, coeffs8_64: torch.Tensor,
                at64: projection.AtTable, gram_lu) -> torch.Tensor:
    """Exact float64 P v for a float64 vector on its device: A v and
    A^T z there (``at64``: A^T's table, float64), the (m,) Gram solve
    z = (A A^T)^{-1} A v on the host with the splu factor (the only
    crossing: two (m,) vectors)."""
    a = projection.a_apply(v, nodes8, coeffs8_64).cpu().numpy()
    z = torch.as_tensor(gram_lu.solve(a), device=v.device)
    return v - projection.at_apply(z, at64, v.shape[0])


def defect_f64(u: torch.Tensor, b: torch.Tensor, nodes8: torch.Tensor,
               coeffs8_64: torch.Tensor, at64: projection.AtTable, gram_lu,
               cell: float, shape) -> torch.Tensor:
    """P (b - H u) in float64 on the device (H = -L, so b - H u = b + L u)."""
    r = b + stencil.laplacian_apply(u.reshape(shape), cell).reshape(-1)
    return project_f64(r, nodes8, coeffs8_64, at64, gram_lu)


def defect_host(u64: np.ndarray, b64: np.ndarray, A, gram_lu, cell: float,
                shape) -> np.ndarray:
    """P (b - H u) in host NumPy float64 (the JAX package's host mode)."""
    Hu = -_laplacian_apply_np(u64.reshape(shape), cell).reshape(-1)
    return projection.host_project(b64 - Hu, A, gram_lu)


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

    nodes8, coeffs8 = np.asarray(arrays["nodes8"]), np.asarray(arrays["coeffs8"], np.float64)
    return dict(
        grid=grid,
        spacing=float(arrays["spacing"]),
        nodes8=dev(nodes8, torch.int64),
        coeffs8=dev(coeffs8, dtype),
        # A^T as a gather table: for the compute dtype's projector and for
        # the float64 defect correction
        at=projection.at_table(nodes8, coeffs8, device, dtype),
        at64=projection.at_table(nodes8, coeffs8, device, torch.float64),
        # host copies for the float64 defect correction
        nodes8_host=nodes8,
        coeffs8_f64=coeffs8,
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
        check_inputs(geom, options)
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
                b, cached["nodes8"], cached["coeffs8"], cached["gram"], cached["at"], cell,
                grid.shape, tol, options.solver_maxiter, pins=pins)
            tm.note(f"projected_cg iters={iters} rel_res={resid:.2e}")
            self.last_stats["iters"] = iters
            self.last_stats["rel_res"] = resid

        if options.refine_steps > 0 and dtype == torch.float32:
            u = self._refine_or_skip(u, Y, cached, grid, is_mesh, options, tm)

        with tm.phase("mean shift along source"):
            phi = _mean_shift(-u, cached["src_nodes8"], cached["src_coeffs8"],
                              cached["weights"])

        self.last_stats["phases"] = tm.as_dict()
        self.last_stats["tform_eps"] = cached["gram"].tform_eps
        if self.device.type == "cuda":
            self.last_stats["mem_peak_mb"] = (
                torch.cuda.max_memory_allocated(self.device) / 1e6)
        return GridResult(phi, grid, Y, u_dev=u)

    def _refine_or_skip(self, u, Y, cached, grid, is_mesh, options, tm):
        """The default tier's dispatch: the float64 defect correction of the
        float32 solve, or the float32 solution with ``refine_skipped``
        recorded (above REFINE_MAX_NODES, or once the correction has run
        out of device memory for this discretization; recorded on every
        solve it skips)."""
        if grid.total_nodes > REFINE_MAX_NODES:
            self.last_stats["refine_skipped"] = (
                f"grid {grid.total_nodes:,} nodes > REFINE_MAX_NODES")
            tm.note("refinement skipped: grid too large for the f64 defect "
                    "correction (f32 solution, rel_res ~1e-5)")
            return u
        if not cached.get("_refine_oom"):
            with tm.phase("float64 defect correction"):
                try:
                    return self._refine(u, Y, cached, grid, is_mesh, options, tm)
                except torch.cuda.OutOfMemoryError:
                    cached["_refine_oom"] = True
        self.last_stats["refine_skipped"] = "device OOM"
        tm.note("refinement skipped: device memory exhausted at this grid "
                "size; returning the f32 solution")
        warnings.warn(
            "shm3d_torch: f64 defect correction exhausted device memory at "
            "this grid size; returning the f32 fast-tier solution (rel_res "
            "~1e-5)")
        return u

    def _host_gram(self, cached, grid):
        """(A, splu(A A^T)) of all constraint rows, cached per
        discretization."""
        host = cached.get("host_gram")
        if host is None:
            host = projection.host_gram_factor(
                cached["nodes8_host"], cached["coeffs8_f64"], grid.total_nodes)
            cached["host_gram"] = host
        return host

    def _refine(self, u, Y, cached, grid, is_mesh, options, tm):
        """Defect correction around the float32 solve (shm3d's ``_refine``
        and ``_refine_pair``).  Each pass solves the scaled projected defect
        in float32 and adds it to the float64 iterate, which is then
        re-projected onto ker(A) exactly.  The pass budget comes from the
        starting residual (``options.refine_pass_budget``); the loop stops
        at ``refine_target`` or when a pass contracts the defect less than
        2x.  Returns u in the compute dtype."""
        shape = grid.shape
        cell = float(grid.cell_size)
        A, lu = self._host_gram(cached, grid)
        rels = self.last_stats.setdefault("refine_pass_rels", [])
        tiny = float(np.finfo(np.float64).tiny)
        pair = options.refine_mode == "pair"
        if pair:
            # native float64 on the device: b, A u, A^T z and b - H u;
            # only the (m,) Gram solve crosses to the host
            nodes8 = cached["nodes8"]
            c64 = cached.get("coeffs8_dev64")
            if c64 is None:
                c64 = torch.as_tensor(cached["coeffs8_f64"], device=u.device)
                cached["coeffs8_dev64"] = c64
            detail = self.last_stats.setdefault(
                "refine_detail", {"project_s": 0.0, "correction_s": 0.0})

            def timed(fn, key):
                def run(*args):
                    t0 = time.perf_counter()
                    out = fn(*args)
                    synchronize(u.device)
                    detail[key] += time.perf_counter() - t0
                    return out
                return run

            at64 = cached["at64"]
            project = timed(lambda v: project_f64(v, nodes8, c64, at64, lu), "project_s")
            defect = timed(lambda v: defect_f64(v, b, nodes8, c64, at64, lu, cell, shape),
                           "project_s")
            correct = timed(lambda r, rel: self._correction_solve(
                r.to(u.dtype), cached, grid, options, rel=rel), "correction_s")
            b = -_rhs_div(Y.to(torch.float64), cell, shape, is_mesh)
            norm = lambda v: float(torch.linalg.vector_norm(v))
            absmax = lambda v: float(v.abs().max())
            widen = lambda d: d.to(torch.float64)
            record = lambda rel: float("%.3e" % rel)
            x = u.to(torch.float64)
        else:
            # host NumPy float64 throughout
            Y64 = Y.detach().cpu().numpy().astype(np.float64).reshape(*shape, 3)
            div64 = _div64_np(Y64, cell)
            if is_mesh:
                div64 = np.where(np.isfinite(div64), div64, 0.0)
            b = -div64
            project = lambda v: projection.host_project(v, A, lu)
            defect = lambda v: defect_host(v, b, A, lu, cell, shape)
            correct = lambda r, rel: self._correction_solve(
                torch.as_tensor(r, dtype=u.dtype, device=u.device), cached, grid,
                options, rel=rel)
            norm = lambda v: float(np.linalg.norm(v))
            absmax = lambda v: float(np.abs(v).max())
            widen = lambda d: d.detach().cpu().numpy().astype(np.float64)
            record = float
            x = u.detach().cpu().numpy().astype(np.float64)

        bnorm = max(norm(project(b)), tiny)
        x = project(x)  # restore A u = 0 before measuring the defect
        r = defect(x)
        rel = norm(r) / bnorm
        rels.append(record(rel))
        for _ in range(options.refine_pass_budget(rel)):
            if not np.isfinite(rel) or rel <= options.refine_target:
                tm.note(f"refine skipped/stopped at rel_res={rel:.2e}")
                break
            scale = absmax(r)
            scale = scale if scale > 0 else 1.0
            x = project(x + scale * widen(correct(r / scale, rel)))
            r = defect(x)
            new_rel = norm(r) / bnorm
            rels.append(record(new_rel))
            stalled = not np.isfinite(new_rel) or new_rel > 0.5 * rel
            rel = new_rel if np.isfinite(new_rel) else rel
            if stalled:
                break
        self.last_stats["refine_rel_res"] = float(rel)
        return torch.as_tensor(x, device=u.device).to(u.dtype)

    # copied from shm3d/solvers/grid.py (_correction_tol)
    @staticmethod
    def _correction_tol(options, rel=None, exact_projector=True) -> float:
        """Per-pass tolerance for a float32 correction solve: aimed at the
        remaining contraction refine_target / rel, rounded up to a decade,
        within [1e-5, refine_solver_tol].  The whitened full-row factor
        (tmat) contracts ~1e-2 per pass whatever the tolerance, so it takes
        refine_solver_tol (exact_projector=False)."""
        hi = options.refine_solver_tol
        if not exact_projector:
            return hi
        lo = 1e-5  # f32 Krylov floor (resolved_solver_tol)
        if rel is None or not np.isfinite(rel) or rel <= 0:
            return hi
        needed = options.refine_target / rel
        return float(min(max(10.0 ** np.ceil(np.log10(max(needed, lo))), lo),
                         hi))

    def _correction_solve(self, rhs: torch.Tensor, cached, grid, options,
                          rel=None) -> torch.Tensor:
        """Projected MG-PCG on the (scaled) defect in float32: the primary
        solve's operator, projector and pin masks with a loose per-pass
        tolerance (``_correction_tol``).  Records ``correction_iters``."""
        if cached.get("pin_keep") is not None:
            raise NotImplementedError(
                "the defect correction of a subsampled-pin solve projects "
                "with the full row set through the host-projected loop, not "
                "ported yet (ROADMAP A10)")
        gram = cached["gram"]
        du, iters, _ = _solve_pinned(
            rhs, cached["nodes8"], cached["coeffs8"], gram, cached["at"],
            float(grid.cell_size), grid.shape,
            self._correction_tol(options, rel,
                                 exact_projector=gram.bmat is not None),
            options.solver_maxiter, pins=cached.get("pin_masks"))
        self.last_stats.setdefault("correction_iters", []).append(int(iters))
        return du

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
        """Source quadrature, memoized on the geometry object under an
        attribute of the port's own (never the JAX package's memo)."""
        cached = getattr(geom, "_shm3d_torch_sources", None)
        if cached is None:
            cached = src_mod.from_geometry(geom)
            try:
                setattr(geom, "_shm3d_torch_sources", cached)
            except AttributeError:
                pass
        return cached
