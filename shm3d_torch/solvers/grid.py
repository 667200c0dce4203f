"""Grid-domain solver: the device pipeline on a regular grid (port of
shm3d.solvers.grid).

  host:   sources + grid spec + trilinear constraint rows + Gram artifacts
          (NumPy, cached in memory and on disk)
  device: Yukawa kernel (dense or shell) -> adjoint divergence ->
          projected pin-aware MG-PCG -> [float64 defect correction] ->
          mean shift;  or, with ``fast_integration``, greedy integration
          (the host BFS up to 32^3, the device wavefront beyond)

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

The projector's tier follows the row count m as in shm3d: ``bmat`` up to
ORTHO_GRAM_CAP; past it in float32 with ``max_device_pins`` set, the
full-row factor up to TFORM_FULL_CAP and then subsampled pins (the device
solve pins a spatially separated subset of the rows, and the defect
correction projects with all of them through the host loop); otherwise the
host-projected loop (each iteration's two Gram solves by the host splu
factor of all rows).

``solver_method="minres_kkt"`` solves the saddle itself instead:
block-preconditioned MINRES on [[-L, -A^T], [-A, 0]] (u, mu) = (b, 0) over
the pinned rows, on every tier (it needs no Gram factor), followed by the
same defect correction.  Its iteration count depends on the grid, and in
float32 it stalls near roundoff, up to ``solver_maxiter``, as shm3d's does.

``GridSolver(mesh=)`` runs the same solve on a device mesh
(shm3d_torch.parallel.device_mesh, 1-D or 2-D): Step 1 splits the shell
kernel's rows over the shards (or runs the dense kernel on the ring
schedule), and Step 3 holds every node vector as z-slabs (``Shards``): the
stencils and the V-cycle with one-plane halos, A u and A^T y through the
rows' gather tables, CG dots summed in shard order, the (m,) vectors and
factors on the mesh's first device.  The greedy paths, the mean shift and
the result gather onto the first device.  A grid whose n does not split
over the mesh (or leaves a shard fewer than two planes) is solved on the
first device, as in shm3d, and ``last_stats["mesh"]["fallback"]`` says so.
"""

from __future__ import annotations

import math
import warnings
from typing import Optional

import numpy as np
import torch

from ..config import SignedHeatOptions
from ..domains import grid as griddom
from ..geometry import sources as src_mod
from ..io.mesh_io import Mesh
from ..utils import diskcache

from .._device import reset_peak_memory, resolve_device, torch_dtype
from .._inputs import check_inputs
from ..ops import farfield, stencil
from ..ops.wavefront import greedy_integrate_wavefront
from ..ops.yukawa import yukawa_chunk_len, yukawa_field
from ..oracle.reference import integrate_greedily_grid
from ..parallel import slab
from ..parallel.ring import yukawa_field_ring
from ..parallel.shards import DeviceMesh, Shards, shard_rows
from ..solve import graphs as graph_mod
from ..solve import krylov, multigrid, projection
from ..utils import checks, timing
from ..utils.timing import HOST, LAUNCH, WAIT, PhaseTimer

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
    access (its spans go to the solve's ``last_stats["spans"]`` through
    ``spans``, the solve's recorder)."""

    def __init__(self, phi_dev: torch.Tensor, grid: griddom.GridSpec,
                 Y: Optional[torch.Tensor] = None,
                 u_dev: Optional[torch.Tensor] = None,
                 spans: Optional[PhaseTimer] = None):
        self._phi_dev = phi_dev
        self._phi_host: Optional[np.ndarray] = None
        self.grid = grid
        self.Y = Y              # (N, 3) normalized Step-2 field
        self.u_device = u_dev   # (N,) primal solution before phi = -u + shift
        self._spans = spans

    @property
    def phi(self) -> np.ndarray:
        if self._phi_host is None:
            with timing.after(self._spans, "phi to host", WAIT):
                phi = self._phi_dev.detach().cpu()
            with timing.after(self._spans, "phi to float64", HOST):
                self._phi_host = phi.numpy().astype(np.float64)
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


def _lap(u, cell_size: float, shape):
    """L u of a flat node vector, or of its z-slabs."""
    if isinstance(u, Shards):
        n = shape[-1]
        lu = slab.laplacian_apply([p.reshape(-1, n, n) for p in u.parts], cell_size)
        return Shards([x.reshape(-1) for x in lu], u.mesh)
    return stencil.laplacian_apply(u.reshape(shape), cell_size).reshape(-1)


def _rhs_div(Y, cell_size: float, shape, guard_nans: bool):
    """Adjoint divergence of the normalized field (flat, or z-slabs); on
    meshes the NaN rows of a node coincident with a source are zeroed (as
    the reference does)."""

    def guard(div):
        if guard_nans:
            div = torch.where(torch.isfinite(div), div, torch.zeros_like(div))
        return div

    if isinstance(Y, Shards):
        n = shape[-1]
        div = slab.divergence_apply([p.reshape(-1, n, n, 3) for p in Y.parts], cell_size)
        return Shards([guard(d.reshape(-1)) for d in div], Y.mesh)
    return guard(stencil.divergence_apply(Y.reshape(*shape, 3), cell_size).reshape(-1))


def _norm(v) -> float:
    return float(torch.linalg.vector_norm(v)) if isinstance(v, torch.Tensor) else float(v.norm())


def _host(v) -> np.ndarray:
    """A node vector or field (or its z-slabs) as a float64 host array."""
    if isinstance(v, Shards):
        v = v.gather()
    return v.detach().cpu().numpy().astype(np.float64)


def _on_device(a: np.ndarray, like, dtype: torch.dtype):
    """Host array ``a`` where ``like`` lives (split into its z-slabs)."""
    t = torch.as_tensor(a, dtype=dtype, device=like.device)
    return shard_rows(t, like.mesh) if isinstance(like, Shards) else t


def _solve_pinned(b, nodes8, coeffs8, gram, at, cell_size: float, shape, tol: float,
                  maxiter: int, pins=None, host_gram=None, stats=None, graphs=None):
    """Projected MG-PCG on P H P u = P b in one run (no restarts).  Returns
    (u, iterations, relative preconditioned residual) with u in ker(A).
    Both the matvec and the preconditioner project: MG applied to an
    unprojected residual builds wrong search directions.  A Gram table
    with neither factor takes the host-projected loop (``host_gram``: the
    host factor of these rows; ``stats`` its counters).  ``graphs``: the
    discretization's dict of graphs (``solve.graphs``); on one CUDA device
    the solve is the setup graph and the chunk graph of its loop kept there
    (``krylov.cg_run``; the host-projected loop three graphs an
    iteration)."""
    if gram.bmat is None and gram.tmat is None:
        return _solve_pinned_hostproj(b, nodes8, coeffs8, at, host_gram, cell_size,
                                      shape, tol, maxiter, stats, graphs)
    N = b.shape[0]
    proj = projection.make_projector(nodes8, coeffs8, gram, N, at)
    mg = multigrid.make_node_preconditioner(shape, cell_size, pins=pins)

    def matvec(u):
        # u stays in ker(A) along the recurrence, so P H P u = P (H u)
        return proj(-_lap(u, cell_size, shape))

    def precond(r):
        return proj(mg(r))

    # P b and ||P b||_M inside the setup (on one card its graph)
    res = krylov.cg_run(matvec, b, precond=precond, tol=tol, maxiter=maxiter,
                        stall_window=60, prep=proj,
                        runner=graph_mod.runner(graphs, ("projected-cg", shape, b.dtype), b))
    rel = res.residual / max(res.rhs_mnorm, torch.finfo(b.dtype).tiny)
    return res.x, res.iterations, rel


class KKTPair:
    """A vector (u, mu) of the KKT system: u a flat node vector or its
    z-slabs (``Shards``), mu the (m,) multipliers on the (first) device.
    Arithmetic is part by part; the dot is u's (in shard order) plus mu's."""

    __slots__ = ("u", "mu")

    def __init__(self, u, mu: torch.Tensor):
        self.u, self.mu = u, mu

    def __add__(self, o):
        return KKTPair(self.u + o.u, self.mu + o.mu)

    def __sub__(self, o):
        return KKTPair(self.u - o.u, self.mu - o.mu)

    def __mul__(self, s):
        return KKTPair(self.u * s, self.mu * s)

    __rmul__ = __mul__

    def __truediv__(self, s):
        return KKTPair(self.u / s, self.mu / s)

    def dot(self, o) -> torch.Tensor:
        return krylov.dot(self.u, o.u) + torch.dot(self.mu, o.mu)

    def zeros_like(self):
        return KKTPair(krylov.zeros_like(self.u), torch.zeros_like(self.mu))

    def clone(self):
        return KKTPair(self.u.clone(), self.mu.clone())

    def copy_(self, o):
        self.u.copy_(o.u)
        self.mu.copy_(o.mu)
        return self


def _kkt_matvec(x: KKTPair, nodes8, coeffs8: torch.Tensor, at, cell_size: float,
                shape) -> KKTPair:
    """[[-L, -A^T], [-A, 0]] (u, mu)."""
    N = shape[0] * shape[1] * shape[2]
    Hu = -_lap(x.u, cell_size, shape)
    return KKTPair(Hu - projection.at_apply(x.mu, at, N),
                   -projection.a_apply(x.u, nodes8, coeffs8))


def _solve_kkt_minres(b, nodes8, coeffs8: torch.Tensor, at, cell_size: float, shape,
                      tol: float, maxiter: int, graphs=None):
    """MINRES on the KKT saddle [[-L, -A^T], [-A, 0]] (u, mu) = (b, 0) from
    zero, in one run of ``maxiter`` (shm3d's ``_solve_kkt_minres`` off the
    TPU, where its chunk is ``maxiter``).  Block-diagonal preconditioner:
    one V-cycle without pin masks on u, and mu over the Schur diagonal
    estimate sum_j c_j^2 / diag(H)[node_j].  Returns (u, iterations, final
    phibar).  ``graphs`` as in ``_solve_pinned``: on one CUDA device a
    setup graph and the chunk graphs of iteration 0 and the loop."""
    diag_H = -stencil.laplacian_diagonal(shape, cell_size, b.dtype, b.device).reshape(-1)
    if isinstance(b, Shards):
        diag_rows = nodes8.values(shard_rows(diag_H, b.mesh))
    else:
        diag_rows = diag_H[nodes8]
    diag_S = (coeffs8 * coeffs8 / diag_rows).sum(dim=1)
    mg = multigrid.make_node_preconditioner(shape, cell_size)

    def matvec(x):
        return _kkt_matvec(x, nodes8, coeffs8, at, cell_size, shape)

    def precond(r):
        return KKTPair(mg(r.u), r.mu / diag_S)

    # the rhs (b, 0) and its preconditioned norm inside the setup (on one
    # card its graph)
    res = krylov.minres_run(matvec, b, precond=precond, tol=tol, maxiter=maxiter,
                            rhs_mnorm=lambda rhs: torch.sqrt(torch.abs(krylov.dot(
                                rhs, precond(rhs)))),
                            prep=lambda u: KKTPair(u, coeffs8.new_zeros(coeffs8.shape[0])),
                            runner=graph_mod.runner(graphs, ("minres-kkt", shape, b.dtype), b))
    return res.x.u, res.iterations, res.residual


# copied from shm3d/solvers/grid.py (_solve_pinned_hostproj): residual
# checks every CHECK_EVERY iterations; the loop stops after STALL_CHECKS
# checks without a 2% gain on the best residual (preconditioned CG's
# residual is not monotonic: shm3d measured a 6x excursion over ~12
# iterations at 256^3)
HOSTPROJ_CHECK_EVERY = 4
HOSTPROJ_STALL_CHECKS = 6


def _solve_pinned_hostproj(b, nodes8, coeffs8, at, host_gram, cell_size: float, shape,
                           tol: float, maxiter: int, stats=None, graphs=None):
    """Projected MG-PCG with the exact float64 projection on the host
    (shm3d's ``_solve_pinned_hostproj``): the node-space matvec, V-cycle
    (without pin masks), A and A^T run on the device, and each of the two
    projections of an iteration sends an (m,) vector to the host splu solve
    of A A^T and back.  Returns (u, iterations, relative preconditioned
    residual) with u in ker(A).  ``stats`` (a dict) counts the Gram solves
    (``gram_solves``); their host time is one tally span of the solve's
    recorder (``utils.timing``).  ``graphs`` as in
    ``_solve_pinned``: on one CUDA device an iteration is three graph
    replays (``_hostproj_segments``, shm3d's ``_hp_step1/2/3``) with the
    two Gram solves between them; the graph reads every row's tables (the
    only tables this loop is given), so the primary and correction solves
    of a discretization share it."""
    with timing.span("host-projected cg solve", timing.GROUP) as sp:
        u, k, rel = _hostproj_loop(b, nodes8, coeffs8, at, host_gram, cell_size, shape,
                                   tol, maxiter, {} if stats is None else stats, graphs)
        sp.set(iters=k)
    return u, k, rel


def _hostproj_loop(b, nodes8, coeffs8, at, host_gram, cell_size: float, shape,
                   tol: float, maxiter: int, stats: dict, graphs):
    _, lu = host_gram
    N = b.shape[0]
    mg = multigrid.make_node_preconditioner(shape, cell_size)
    stats.setdefault("gram_solves", 0)

    def gram(a: np.ndarray) -> np.ndarray:
        with timing.tally("Gram lu.solve", HOST):
            z = lu.solve(a)
        stats["gram_solves"] += 1
        return z

    def to_host(get) -> np.ndarray:
        with timing.tally("A v to host", WAIT):
            return get().numpy().astype(np.float64)

    def a_of(v):
        return projection.a_apply(v, nodes8, coeffs8)

    def at_of(z):
        return projection.at_apply(z, at, N)

    def proj(v):
        z = gram(to_host(a_of(v).cpu))
        return v - at_of(torch.as_tensor(z, device=v.device).to(v.dtype))

    def hmatvec(u):
        return -_lap(u, cell_size, shape)

    # u = 0, so the first residual is P b and its preconditioned image
    r = proj(b)
    z = proj(mg(r))
    rz = krylov.dot(r, z)
    bnorm = math.sqrt(abs(float(rz)))
    threshold = tol * max(bnorm, float(np.finfo(np.float32).tiny))
    s = dict(u=krylov.zeros_like(b), r=r, p=z, rz=rz)
    run = graph_mod.hostproj_runner(graphs, ("host-projected", "all rows", shape, b.dtype), b)
    if run is None:
        def iterate():
            hostproj_iteration(s, hmatvec, mg, proj)
    else:
        m = coeffs8.shape[0]
        init = dict(s, Hp=torch.zeros_like(b), Mr=torch.zeros_like(b),
                    a1=b.new_zeros(m), a2=b.new_zeros(m),
                    z1=b.new_zeros(m, dtype=torch.float64),
                    z2=b.new_zeros(m, dtype=torch.float64))
        stepper = run(init, lambda st: _hostproj_segments(st, hmatvec, mg, a_of, at_of),
                      exchange=("a1", "a2", "z1", "z2"))
        s = stepper.state

        def iterate():
            stepper.step(0)
            stepper.write("z1", torch.from_numpy(gram(to_host(lambda: stepper.read("a1")))))
            stepper.step(1)
            stepper.write("z2", torch.from_numpy(gram(to_host(lambda: stepper.read("a2")))))
            stepper.step(2)

    best = resid = bnorm
    since = k = 0
    while resid > threshold and k < maxiter and since < HOSTPROJ_STALL_CHECKS:
        for _ in range(min(HOSTPROJ_CHECK_EVERY, maxiter - k)):
            iterate()
            k += 1
        with timing.tally("residual read", WAIT):
            resid = math.sqrt(abs(float(s["rz"])))
        if resid < 0.98 * best:
            best, since = resid, 0
        else:
            since += 1
    u = s["u"] if run is None else s["u"].clone()
    return u, k, resid / max(bnorm, float(np.finfo(np.float64).tiny))


def hostproj_iteration(s: dict, hmatvec, mg, proj) -> None:
    """One iteration of the host-projected loop, eager, on the state ``s``
    (u, r, p, rz): ``proj`` makes its host Gram solve inside."""
    Ap = proj(hmatvec(s["p"]))
    pAp = krylov.dot(s["p"], Ap)
    # 0/0 after convergence inside a batch (residuals are read only every
    # HOSTPROJ_CHECK_EVERY iterations)
    alpha = torch.where(pAp != 0, s["rz"] / pAp, torch.zeros_like(pAp))
    s["u"] = s["u"] + alpha * s["p"]
    s["r"] = s["r"] - alpha * Ap
    z = proj(mg(s["r"]))
    rz_new = krylov.dot(s["r"], z)
    s["p"] = z + torch.where(s["rz"] != 0, rz_new / s["rz"], torch.zeros_like(s["rz"])) * s["p"]
    s["rz"] = rz_new


def _hostproj_segments(s: dict, hmatvec, mg, a_of, at_of):
    """``hostproj_iteration`` as three in-place bodies on the state ``s``
    (shm3d's ``_hp_step1/2/3``), its ops in their order, each ending in
    ``copy_`` into the state: (1) H p and A (H p) into ``a1``; the host
    puts the Gram solve z1 into ``z1`` (float64); (2) the CG step and the
    V-cycle of r, A (M r) into ``a2``; the host puts z2 into ``z2``; (3) the
    new direction.  The Gram solutions are cast to the compute dtype on the
    device, as the eager loop casts them."""

    def step1():
        Hp = hmatvec(s["p"])
        a1 = a_of(Hp)
        s["Hp"].copy_(Hp)
        s["a1"].copy_(a1)

    def step2():
        Ap = s["Hp"] - at_of(s["z1"].to(s["Hp"].dtype))
        pAp = krylov.dot(s["p"], Ap)
        alpha = torch.where(pAp != 0, s["rz"] / pAp, torch.zeros_like(pAp))
        u = s["u"] + alpha * s["p"]
        r = s["r"] - alpha * Ap
        Mr = mg(r)
        a2 = a_of(Mr)
        for k, v in (("u", u), ("r", r), ("Mr", Mr), ("a2", a2)):
            s[k].copy_(v)

    def step3():
        z = s["Mr"] - at_of(s["z2"].to(s["Mr"].dtype))
        rz_new = krylov.dot(s["r"], z)
        p = z + torch.where(s["rz"] != 0, rz_new / s["rz"], torch.zeros_like(s["rz"])) * s["p"]
        s["p"].copy_(p)
        s["rz"].copy_(rz_new)

    return step1, step2, step3


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


def project_f64(v, nodes8, coeffs8_64: torch.Tensor, at64, gram_lu):
    """Exact float64 P v for a float64 vector on its device (or z-slabs): A v and
    A^T z there (``at64``: A^T's table, float64), the (m,) Gram solve
    z = (A A^T)^{-1} A v on the host with the splu factor (the only
    crossing: two (m,) vectors)."""
    a = projection.a_apply(v, nodes8, coeffs8_64)
    with timing.span("A v to host", WAIT):
        a = a.cpu().numpy()
    with timing.span("Gram lu.solve", HOST):
        z = gram_lu.solve(a)
    z = torch.as_tensor(z, device=v.device)
    return v - projection.at_apply(z, at64, v.shape[0])


def defect_f64(u, b, nodes8, coeffs8_64: torch.Tensor, at64, gram_lu, cell: float,
               shape):
    """P (b - H u) in float64 on the device (H = -L, so b - H u = b + L u)."""
    r = b + _lap(u, cell, shape)
    return project_f64(r, nodes8, coeffs8_64, at64, gram_lu)


def defect_host(u64: np.ndarray, b64: np.ndarray, A, gram_lu, cell: float,
                shape) -> np.ndarray:
    """P (b - H u) in host NumPy float64 (the JAX package's host mode)."""
    with timing.span("defect (host float64)", HOST):
        Hu = -_laplacian_apply_np(u64.reshape(shape), cell).reshape(-1)
        return projection.host_project(b64 - Hu, A, gram_lu)


def cached_from_arrays(arrays: dict, device, dtype: torch.dtype) -> dict:
    """Device operator-cache entry from the host arrays of
    ``GridSolver._build_host_arrays`` (either package: the format is the
    same).  ``nodes8``/``coeffs8``/``at``/``at64`` hold all constraint rows
    (the host loop, the float64 defect correction); ``pin_nodes8``/
    ``pin_coeffs8``/``pin_at`` the rows the device solve pins, a subset
    only on the subsampled tier (``pin_keep``)."""
    grid = griddom.GridSpec(
        bbox_min=tuple(np.asarray(arrays["grid_bbox_min"], np.float64)),
        cell_size=float(arrays["grid_cell"]),
        n=int(arrays["grid_n"]),
    )
    gram_arrays = {
        k[len("gram_"):]: v for k, v in arrays.items() if k.startswith("gram_")
    }

    def dev(a, dt):
        return torch.as_tensor(np.asarray(a), device=device).to(dt)

    nodes8, coeffs8 = np.asarray(arrays["nodes8"]), np.asarray(arrays["coeffs8"], np.float64)
    pin_keep = arrays.get("pin_keep")
    cached = dict(
        grid=grid,
        spacing=float(arrays["spacing"]),
        nodes8=dev(nodes8, torch.int64),
        coeffs8=dev(coeffs8, dtype),
        # A^T as a gather table: for the compute dtype and for the float64
        # defect correction
        at=projection.at_table(nodes8, coeffs8, device, dtype),
        at64=projection.at_table(nodes8, coeffs8, device, torch.float64),
        # host copies for the float64 defect correction
        nodes8_host=nodes8,
        coeffs8_f64=coeffs8,
        pin_keep=None if pin_keep is None else np.asarray(pin_keep),
        gram=projection.gram_from_arrays(gram_arrays, device, dtype),
        src_nodes8=dev(arrays["src_nodes8"], torch.int64),
        src_coeffs8=dev(arrays["src_coeffs8"], dtype),
        points=dev(arrays["points"], dtype),
        vectors=dev(arrays["vectors"], dtype),
        weights=dev(arrays["weights"], dtype),
    )
    if pin_keep is None:
        cached.update(pin_nodes8=cached["nodes8"], pin_coeffs8=cached["coeffs8"],
                      pin_at=cached["at"])
    else:
        keep = cached["pin_keep"]
        cached.update(pin_nodes8=dev(nodes8[keep], torch.int64),
                      pin_coeffs8=dev(coeffs8[keep], dtype),
                      pin_at=projection.at_table(nodes8[keep], coeffs8[keep], device, dtype))
    gram = cached["gram"]
    if gram.bmat is None and gram.tmat is None:
        # host-projected tier: every iteration projects through the host
        # factor of all rows, built up front
        cached["host_gram"] = projection.host_gram_factor(nodes8, coeffs8, grid.total_nodes)
    return cached


def _graphs(cached) -> dict:
    """The CUDA graphs of a discretization's loops (Krylov iterations, the
    host-projected loop's segments, the wavefront's chunks; keyed by loop
    kind, shape and dtype; ``solve.graphs``), kept in its cache entry beside
    the tensors they read.  Solves on z-slabs run eagerly and keep none."""
    return cached.setdefault("graphs", {})


def _tier(cached) -> str:
    """The projector's tier of a cache entry: "bmat", "full-row",
    "subsampled" or "host-projected"."""
    gram = cached["gram"]
    if gram.bmat is not None:
        return "bmat"
    if gram.tmat is None:
        return "host-projected"
    return "full-row" if cached["pin_keep"] is None else "subsampled"


class GridSolver:
    """Stateful grid solver with the reference caching contract: the
    discretization of a geometry is built once per (geometry, options
    cache key) and reused by later solves.

    ``device`` is required to exist: "cuda" without a visible card raises,
    and nothing falls back to the CPU.  With a ``mesh``
    (shm3d_torch.parallel.device_mesh) the solve runs on its shards and
    ``device`` is the mesh's first device."""

    def __init__(self, device="cuda", mesh: Optional[DeviceMesh] = None):
        self.mesh = mesh
        self.device = resolve_device(device if mesh is None else mesh.first)
        if mesh is not None:
            for d in mesh.devices:
                resolve_device(d)
        self._cache = {}
        self.last_stats = {}

    def compute_distance(self, geom, options: SignedHeatOptions = SignedHeatOptions()) -> GridResult:
        check_inputs(geom, options)
        dtype = torch_dtype(options.dtype)
        tm = PhaseTimer(self.device, verbose=options.verbose)
        self.last_stats = {}
        with tm.solve(self.last_stats):
            return self._solve(geom, options, dtype, tm)

    def _solve(self, geom, options, dtype, tm) -> GridResult:
        is_mesh = isinstance(geom, Mesh)
        tol = options.resolved_solver_tol()
        reset_peak_memory(self.device)

        with tm.phase("precompute (sources + grid + constraints)"):
            with timing.span("cache lookup (geometry hash)", HOST):
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
        mesh = self._use_mesh(grid, tm)

        with tm.phase("steps 1&2 (Yukawa convolution + normalize)"):
            use_shell = (
                options.step1_method == "shell"
                or (options.step1_method == "auto" and grid.n >= options.shell_auto_n)
            )
            pts, vecs = cached["points"], cached["vectors"]
            if use_shell:
                plan = self._shell_plan(cached, key, lam, options)
                tm.note(f"shell decomposition: {plan.shell_fraction:.1%} exact "
                        f"nodes + {plan.m}^3 coarse lattice")
                self.last_stats["shell_nodes"] = int(plan.shell_idx.shape[0])
                self.last_stats["coarse_nodes"] = int(plan.coarse_pos.shape[0])
                # K1's source chunks queried before the stage is captured
                chunks = (None, None) if mesh is not None else (
                    self._chunk_len(plan.coarse_pos, pts), self._chunk_len(plan.shell_pos, pts))
                Y = self._stage(
                    cached, ("steps 1-2", "shell", lam, options.shell_t,
                             options.shell_coarse_factor, dtype),
                    lambda: farfield.yukawa_field_shell(plan, pts, vecs, lam, grid.n,
                                                        mesh=mesh, chunks=chunks),
                    eager=mesh is not None)
            elif mesh is not None:
                queries = cached.get("slab_queries")
                if queries is None:
                    queries = shard_rows(_node_positions_device(
                        grid.bbox_min, cell, grid.n, dtype, self.device), mesh)
                    cached["slab_queries"] = queries
                Y = yukawa_field_ring(queries, cached["points"], cached["vectors"], lam, mesh)
            else:
                queries = cached.get("queries")
                if queries is None:
                    queries = _node_positions_device(
                        grid.bbox_min, cell, grid.n, dtype, self.device)
                    cached["queries"] = queries
                chunk = self._chunk_len(queries, pts)
                Y = self._stage(cached, ("steps 1-2", "dense", lam, dtype),
                                lambda: yukawa_field(queries, pts, vecs, lam, chunk=chunk))
            # unit rows except where a node lies on a source (the divergence
            # guard zeroes those)
            checks.check_unit_field("grid Step 2 field", Y)

        if options.fast_integration:
            u = None
            if mesh is not None:
                Y = Y.gather()
                self.last_stats["mesh"]["step3"] = f"gathered onto {self.device}"
            phi = self._integrate_greedily(Y, grid, dtype, tm, _graphs(cached))
        else:
            c = cached if mesh is None else self._slab_tables(cached, grid)
            u = self._integrate_exact(Y, c, grid, is_mesh, tol, options, tm)
            if options.refine_steps > 0 and dtype == torch.float32:
                u = self._refine_or_skip(u, Y, c, grid, is_mesh, options, tm)
            if mesh is not None:
                u, Y = u.gather(), Y.gather()
            phi = u  # phi = -u, negated in the mean shift's stage

        with tm.phase("mean shift along source"):
            negate = u is not None
            phi = self._stage(cached, ("mean shift", negate, grid.shape, phi.dtype),
                              lambda v: _mean_shift(-v if negate else v, cached["src_nodes8"],
                                                    cached["src_coeffs8"], cached["weights"]),
                              phi, eager=mesh is not None)
        checks.check_finite("grid phi", phi)

        self.last_stats["phases"] = tm.as_dict()
        self.last_stats["tier"] = _tier(cached)
        self.last_stats["tform_eps"] = cached["gram"].tform_eps
        if self.device.type == "cuda":
            self.last_stats["mem_peak_mb"] = (
                torch.cuda.max_memory_allocated(self.device) / 1e6)
        return GridResult(phi, grid, Y, u_dev=u, spans=tm)

    def _stage(self, cached, key, fn, *inputs, eager: bool = False):
        """``fn(*inputs)``: on one CUDA device one replay of the stage graph
        kept in the discretization's graphs under ``key`` (the first call
        runs it and captures it; ``solve.graphs.StageGraph``), else (the
        CPU, z-slabs, a mesh: ``eager``) the function itself; a ``launch``
        span named by ``key[0]`` either way."""
        run = None if eager else graph_mod.stage_runner(_graphs(cached), key, self.device)
        with timing.span(f"{key[0]} stage", LAUNCH):
            return fn(*inputs) if run is None else run.get(fn)(*inputs)

    def _chunk_len(self, queries, points) -> Optional[int]:
        """K1's source chunk for this launch on a CUDA device (None on the
        CPU): queried outside the stage graphs, passed in as ``chunk``."""
        if queries.device.type != "cuda":
            return None
        return yukawa_chunk_len(queries.shape[0], points.shape[0], queries.device,
                                queries.dtype)

    def _use_mesh(self, grid, tm) -> Optional[DeviceMesh]:
        """The mesh this grid is solved on, or None: no mesh, or a grid whose
        n does not split over it into slabs of two planes or more (solved
        on the mesh's first device, recorded in last_stats["mesh"])."""
        if self.mesh is None:
            return None
        P = len(self.mesh)
        fallback = grid.n % P != 0 or grid.n // P < 2
        if fallback:
            tm.note(f"grid n={grid.n} does not split over {P} devices into slabs of "
                    f">= 2 planes; falling back to single-device on {self.device}")
        level, n_level = multigrid.slab_gather_level(grid.n, P)
        self.last_stats["mesh"] = dict(
            self.mesh.describe(), fallback=fallback,
            step3="single device" if fallback else "z-slabs",
            gather_level=None if fallback else level,
            gather_n=None if fallback else n_level)
        return None if fallback else self.mesh

    def _slab_tables(self, cached, grid) -> dict:
        """``cached`` with Step 3's row tables and pin masks for the mesh's
        z-slabs (built once per discretization): the rows' node gathers,
        A^T's tables cut per slab, and the slab pin masks.  Everything else
        (coefficients, Gram factors, host arrays) is the first device's."""
        view = cached.get("slab_tables")
        if view is None:
            mesh, slab_len = self.mesh, grid.total_nodes // len(self.mesh)
            rows = projection.NodeGather(cached["nodes8"], mesh, slab_len)
            at = projection.SlabAt(cached["at"], mesh, slab_len)
            view = dict(cached, nodes8=rows, at=at,
                        at64=projection.SlabAt(cached["at64"], mesh, slab_len))
            if cached["pin_keep"] is None:
                view.update(pin_nodes8=rows, pin_at=at)
            else:
                view.update(pin_nodes8=projection.NodeGather(cached["pin_nodes8"], mesh, slab_len),
                            pin_at=projection.SlabAt(cached["pin_at"], mesh, slab_len))
            view["pin_masks"] = multigrid.build_slab_pin_masks(
                cached["pin_nodes8"], grid.n, mesh, cached["coeffs8"].dtype)
            cached["slab_tables"] = view
        return view

    def _integrate_greedily(self, Y, grid, dtype, tm, graphs) -> torch.Tensor:
        """Greedy integration of the normalized field: the reference's BFS
        on the host up to 32^3 (oracle parity where the loop is cheap), the
        wavefront sweeps on the device beyond (same edge increments, another
        spanning tree, so path-dependent values differ), their chunk graphs
        kept in ``graphs``, the discretization's."""
        if grid.n <= 32:
            self.last_stats["step3_path"] = "greedy-bfs"
            with tm.phase("step 3 (greedy BFS integration, host)"):
                with timing.span("Y to host", WAIT):
                    Y64 = Y.detach().cpu().numpy().astype(np.float64)
                with timing.span("greedy BFS", HOST):
                    phi = integrate_greedily_grid(grid, Y64)
                return torch.as_tensor(phi, device=Y.device).to(dtype)
        self.last_stats["step3_path"] = "greedy-wavefront"
        with tm.phase("step 3 (greedy wavefront integration, device)"):
            phi, sweeps, visited = greedy_integrate_wavefront(
                Y.to(dtype), float(grid.cell_size), grid.shape, cache=graphs)
        self.last_stats["wavefront_sweeps"] = sweeps
        self.last_stats["wavefront_visited"] = visited
        return phi

    def _integrate_exact(self, Y, cached, grid, is_mesh, tol, options, tm) -> torch.Tensor:
        """Divergence and the Step-3 solve of the pinned rows: projected
        MG-PCG, or MINRES on the KKT system (``solver_method="minres_kkt"``);
        returns u (phi = -u before the mean shift)."""
        cell = float(grid.cell_size)
        minres = options.solver_method == "minres_kkt"
        self.last_stats["step3_path"] = "minres-kkt" if minres else "projected-mg-pcg"
        with tm.phase("step 3 (divergence + KKT MINRES solve)" if minres
                      else "step 3 (divergence + projected MG-PCG solve)"):
            if cached["pin_keep"] is not None:
                tm.note(f"device solve pins {cached['pin_nodes8'].shape[0]} of "
                        f"{cached['nodes8'].shape[0]} rows (subsampled tier)")
                if options.solver_tol is None:
                    # the subsample bounds the fast tier's accuracy (~1e-3
                    # relative, shm3d's measurement): iterating past 1e-4
                    # is wasted work
                    tol = max(tol, 1e-4)
            b = self._stage(cached, ("divergence", grid.shape, is_mesh, Y.dtype),
                            lambda v: -_rhs_div(v, cell, grid.shape, is_mesh), Y,
                            eager=isinstance(Y, Shards))
            if minres:
                # resid: the absolute phibar, as shm3d records it
                u, iters, resid = _solve_kkt_minres(
                    b, cached["pin_nodes8"], cached["pin_coeffs8"], cached["pin_at"], cell,
                    grid.shape, tol, options.solver_maxiter, _graphs(cached))
            else:
                host_loop = {}
                u, iters, resid = _solve_pinned(
                    b, cached["pin_nodes8"], cached["pin_coeffs8"], cached["gram"],
                    cached["pin_at"], cell, grid.shape, tol, options.solver_maxiter,
                    pins=self._pin_masks(cached, grid), host_gram=cached.get("host_gram"),
                    stats=host_loop, graphs=_graphs(cached))
                if host_loop:
                    self.last_stats["host_loop"] = host_loop
            tm.note(f"{options.solver_method} iters={iters} rel_res={resid:.2e}")
            self.last_stats["iters"] = iters
            self.last_stats["rel_res"] = resid
            checks.check_finite("grid Step 3 solution", u)
            if checks.enabled() and not minres:
                # the null-space invariant: the pinned rows hold on the iterate
                checks.check_constraint(
                    "grid Step 3 pinning", u,
                    lambda v: projection.a_apply(v, cached["pin_nodes8"],
                                                 cached["pin_coeffs8"]),
                    b_scale=_norm(u))
        return u

    @staticmethod
    def _pin_masks(cached, grid):
        """Per-level masks of the pin-aware V-cycle, from the pinned rows,
        cached per discretization."""
        pins = cached.get("pin_masks")
        if pins is None:
            pins = multigrid.build_pin_masks(cached["pin_nodes8"], grid.shape,
                                             cached["coeffs8"].dtype)
            cached["pin_masks"] = pins
        return pins

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
            at64 = cached["at64"]
            project = lambda v: project_f64(v, nodes8, c64, at64, lu)
            defect = lambda v: defect_f64(v, b, nodes8, c64, at64, lu, cell, shape)
            correct = lambda r, rel: self._correction_solve(
                r.to(u.dtype), cached, grid, options, rel=rel)
            b = -_rhs_div(Y.to(torch.float64), cell, shape, is_mesh)
            norm = _norm
            absmax = lambda v: float(v.abs().max())
            widen = lambda d: d.to(torch.float64)
            record = lambda rel: float("%.3e" % rel)
            x = u.to(torch.float64)
            narrow = lambda x: x.to(u.dtype)
        else:
            # host NumPy float64 throughout
            with timing.span("Y to host", WAIT):
                Y64 = _host(Y).reshape(*shape, 3)
            with timing.span("divergence (host float64)", HOST):
                div64 = _div64_np(Y64, cell)
                if is_mesh:
                    div64 = np.where(np.isfinite(div64), div64, 0.0)
            b = -div64

            def project(v):
                with timing.span("project (host float64)", HOST):
                    return projection.host_project(v, A, lu)

            defect = lambda v: defect_host(v, b, A, lu, cell, shape)
            correct = lambda r, rel: self._correction_solve(
                _on_device(r, u, u.dtype), cached, grid, options, rel=rel)
            norm = lambda v: float(np.linalg.norm(v))
            absmax = lambda v: float(np.abs(v).max())
            widen = _host
            record = float
            x = _host(u)
            narrow = lambda x: _on_device(x, u, torch.float64).to(u.dtype)

        bnorm = max(norm(project(b)), tiny)
        x = project(x)  # restore A u = 0 before measuring the defect
        r = defect(x)
        rel = norm(r) / bnorm
        rels.append(record(rel))
        for k in range(options.refine_pass_budget(rel)):
            if not np.isfinite(rel) or rel <= options.refine_target:
                tm.note(f"refine skipped/stopped at rel_res={rel:.2e}")
                break
            with timing.span("defect pass", timing.GROUP, **{"pass": k + 1}):
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
        return narrow(x)

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
        """Projected MG-PCG on the (scaled) defect in the compute dtype: the
        primary solve's operator, projector and pin masks with a loose
        per-pass tolerance (``_correction_tol``).  After a subsampled-pin
        solve the correction holds ALL rows, through the host-projected
        loop (a correction in the larger ker(A_pin), projected back, does
        not contract: shm3d measured the defect growing ~2x a pass).
        Records ``correction_iters``."""
        gram = cached["gram"]
        host_loop = self.last_stats.get("correction_host_loop", {})
        if cached["pin_keep"] is not None:
            du, iters, _ = _solve_pinned_hostproj(
                rhs, cached["nodes8"], cached["coeffs8"], cached["at"],
                self._host_gram(cached, grid), float(grid.cell_size), grid.shape,
                self._correction_tol(options, rel, exact_projector=False),
                options.solver_maxiter, host_loop, _graphs(cached))
        else:
            du, iters, _ = _solve_pinned(
                rhs, cached["pin_nodes8"], cached["pin_coeffs8"], gram, cached["pin_at"],
                float(grid.cell_size), grid.shape,
                self._correction_tol(options, rel,
                                     exact_projector=gram.bmat is not None),
                options.solver_maxiter, pins=self._pin_masks(cached, grid),
                host_gram=cached.get("host_gram"), stats=host_loop, graphs=_graphs(cached))
        if host_loop:
            self.last_stats["correction_host_loop"] = host_loop
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
        projection artifacts of the projector's tier, in shm3d's order."""
        is_mesh = isinstance(geom, Mesh)
        sources = self._sources(geom)
        seed_pts = geom.vertices if is_mesh else geom.positions
        grid = griddom.build_grid(seed_pts, options.scale, options.h_coef)
        nodes8, coeffs8 = griddom.constraint_rows(grid, sources.points)
        src_nodes8, src_coeffs8 = griddom.trilinear_rows(grid, sources.points)
        m = nodes8.shape[0]
        pins = (options.max_device_pins is not None and options.dtype == "float32"
                and m > projection.ORTHO_GRAM_CAP)
        pin_keep = None
        if pins and m <= projection.TFORM_FULL_CAP:
            # full-row whitening tier: the factor of all m rows is built on
            # the device at load (gram_from_arrays)
            gram_arrays = projection.build_tform_full_arrays(
                nodes8, coeffs8, grid.total_nodes)
        elif pins:
            # subsampled tier: the device solve pins a spatially separated,
            # well-conditioned subset of the rows (all rows stay for the
            # defect correction)
            pin_keep = griddom.subsample_pin_rows(
                grid, nodes8, coeffs8, options.max_device_pins)
            gram_arrays = projection.build_tform_arrays(
                nodes8[pin_keep], coeffs8[pin_keep], grid.total_nodes)
        else:
            # bmat up to ORTHO_GRAM_CAP; past it the table has no factor and
            # the solve takes the host-projected loop
            gram_arrays = projection.build_gram_arrays(
                nodes8, coeffs8, grid.total_nodes, options.dtype)
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
        if pin_keep is not None:
            arrays["pin_keep"] = pin_keep.astype(np.int32)
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
