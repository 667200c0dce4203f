"""NumPy/SciPy oracle: an exact float64 transcription of the reference
signed-heat pipeline (copied from shm3d/oracle/reference.py; NumPy and
SciPy only, so the port keeps its own copy).

This module is the executable behavioral spec.  It uses direct sparse solves
(scipy splu / spsolve standing in for geometry-central's CHOLMOD/LU wrappers)
and exact loop semantics, including the reference's quirks:

- per-query normalization of the convolved vector field
  (signed_heat_grid_solver.cpp:60-62),
- the NaN guard zeroing non-finite divergence entries on the mesh-on-grid
  path only (signed_heat_grid_solver.cpp:72-74),
- the always-on soft zero-set KKT pinning on the grid (comment "No level set
  constraints implemented for grid", signed_heat_grid_solver.cpp:75),
- phi = -soln.head (signed_heat_grid_solver.cpp:108,214),
- the FIFO breadth-first "fast" integration with minus-then-plus neighbor
  order (signed_heat_grid_solver.cpp:224-275),
- the final mean shift along the source (signed_heat_grid_solver.cpp:110-111).

Everything here is host NumPy; the port's device path must match it to
rel-L2 <= 1e-5 (BASELINE.md north-star tolerance).
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Optional

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from ..config import SignedHeatOptions
from ..domains import grid as griddom
from ..geometry.sources import SourceDistribution
from ..io.mesh_io import Mesh, PointCloud


# ---------------------------------------------------------------------------
# Steps 1 & 2: closed-form short-time vector diffusion + normalize.


def yukawa_potential(x: np.ndarray, y: np.ndarray, lam: float) -> np.ndarray:
    """exp(-lambda |x-y|) / |x-y| (signed_heat_3d.cpp:45-49)."""
    r = np.linalg.norm(x - y, axis=-1)
    return np.exp(-lam * r) / r


def diffuse_vector_field(
    queries: np.ndarray,
    sources: SourceDistribution,
    lam: float,
    chunk: int = 4096,
    normalize: bool = True,
) -> np.ndarray:
    """X(q) = sum_s n_s w_s yukawa(p_s, q, lambda), then X /= |X| per query.

    Brute-force O(Q x S) double loop of the reference
    (signed_heat_grid_solver.cpp:48-65, signed_heat_tet_solver.cpp:54-72),
    vectorized in f64 with query chunking to bound memory.
    """
    Q = queries.shape[0]
    vecs = sources.vectors()  # (S, 3)
    out = np.zeros((Q, 3), dtype=np.float64)
    for s in range(0, Q, chunk):
        q = queries[s : s + chunk]  # (C, 3)
        diff = q[:, None, :] - sources.points[None, :, :]  # (C, S, 3)
        r = np.linalg.norm(diff, axis=-1)  # (C, S)
        with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
            w = np.exp(-lam * r) / r
        out[s : s + chunk] = w @ vecs
    if normalize:
        with np.errstate(divide="ignore", invalid="ignore"):
            out = out / np.linalg.norm(out, axis=1, keepdims=True)
    return out


# ---------------------------------------------------------------------------
# Grid solver (reference: SignedHeatGridSolver).


@dataclasses.dataclass
class GridResult:
    phi: np.ndarray  # (N,) flat node values
    grid: griddom.GridSpec
    Y: np.ndarray  # (N, 3) normalized vector field


def solve_grid(
    geom,
    options: SignedHeatOptions = SignedHeatOptions(),
    sources: Optional[SourceDistribution] = None,
    grid: Optional[griddom.GridSpec] = None,
) -> GridResult:
    """Full grid pipeline (signed_heat_grid_solver.cpp:5-222)."""
    from ..geometry import sources as src_mod

    is_mesh = isinstance(geom, Mesh)
    if sources is None:
        sources = src_mod.from_geometry(geom)
    if grid is None:
        seed_pts = geom.vertices if is_mesh else geom.positions
        grid = griddom.build_grid(seed_pts, options.scale, options.h_coef)

    # Steps 1 & 2.
    t = options.t_coef * sources.spacing ** 2
    lam = np.sqrt(1.0 / t)
    nodes = grid.node_positions()
    Y = diffuse_vector_field(nodes, sources, lam)

    # Step 3: divergence of the normalized field.
    D = griddom.gradient_matrix(grid)
    div_flat = D.T @ Y.reshape(-1)  # Y rows interleave (x,y,z) per node
    if is_mesh:
        # NaN guard — mesh path only (signed_heat_grid_solver.cpp:72-74).
        div_flat = np.where(np.isfinite(div_flat), div_flat, 0.0)

    if options.fast_integration:
        phi = integrate_greedily_grid(grid, Y)
    else:
        phi = _grid_kkt_solve(grid, div_flat, sources)

    # Mean shift along the source (1-pt quadrature trilinear average,
    # signed_heat_grid_solver.cpp:466-496).
    vals = griddom.evaluate_trilinear(grid, phi, sources.points)
    shift = float(np.sum(sources.weights * vals) / np.sum(sources.weights))
    phi = phi - shift
    return GridResult(phi, grid, Y)


def _grid_kkt_solve(grid: griddom.GridSpec, div: np.ndarray, sources: SourceDistribution) -> np.ndarray:
    """KKT [[L, A^T], [A, 0]] [u; mu] = [div; 0]; phi = -u
    (signed_heat_grid_solver.cpp:77-109)."""
    N = grid.total_nodes
    L = griddom.laplacian_matrix(grid)
    nodes8, coeffs8 = griddom.constraint_rows(grid, sources.points)
    m = nodes8.shape[0]
    rows = np.repeat(np.arange(m), 8)
    A = sp.coo_matrix((coeffs8.ravel(), (rows, nodes8.ravel())), shape=(m, N)).tocsr()
    KKT = sp.bmat([[L, A.T], [A, None]], format="csc")
    rhs = np.concatenate([div, np.zeros(m)])
    soln = spla.spsolve(KKT, rhs)
    return -soln[:N]


def integrate_greedily_grid(grid: griddom.GridSpec, Y: np.ndarray) -> np.ndarray:
    """BFS line integration from corner node (0,0,0) over the 6-neighbor
    lattice; edge increment uses the normalized average of the endpoint
    vectors (signed_heat_grid_solver.cpp:224-275).  FIFO queue; per node the
    neighbors are visited axis-by-axis, minus direction then plus."""
    n = grid.n
    N = grid.total_nodes
    phi = np.zeros(N, dtype=np.float64)
    visited = np.zeros(N, dtype=bool)
    visited[0] = True
    h = grid.cell_size
    queue = collections.deque([(0, 0, 0)])
    while queue:
        ci, cj, ck = queue.popleft()
        cidx = ci + cj * n + ck * n * n
        Yp = Y[cidx]
        for axis in range(3):
            for delta in (-1, 1):
                nijk = [ci, cj, ck]
                nijk[axis] += delta
                if not (0 <= nijk[axis] < n):
                    continue
                nidx = nijk[0] + nijk[1] * n + nijk[2] * n * n
                if visited[nidx]:
                    continue
                Yq = Y[nidx]
                Yavg = Yp + Yq
                Yavg = Yavg / np.linalg.norm(Yavg)
                # edge = position(next) - position(curr)
                phi[nidx] = phi[cidx] + Yavg[axis] * (delta * h)
                visited[nidx] = True
                queue.append(tuple(nijk))
    return phi
