"""Shell decomposition of the Step-1 Yukawa sum on the grid domain (port of
shm3d.ops.farfield).

Step 2 keeps only the direction of X, and that direction is a softmin over
sources: away from the surface it varies on the scale of the distance to
the surface.  So the exact kernel runs on the near-surface shell
(lam * dist <= T) and on a lattice coarsened ``factor`` times per axis;
every other node takes the trilinearly interpolated, renormalized coarse
direction.  The host plan (NumPy + SciPy EDT) is shared with ``shm3d``.
On a device mesh the kernel's query rows are split over the shards with
the sources replicated (``_rowsharded``), and the assembled field ends as
z-slabs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..domains.grid import GridSpec
from ..parallel.shards import broadcast, shard_rows

from .yukawa import query_block, yukawa_chunk_len, yukawa_field

# copied from shm3d/ops/farfield.py (DEFAULT_SHELL_T, DEFAULT_COARSE_FACTOR)
DEFAULT_SHELL_T = 8.0
DEFAULT_COARSE_FACTOR = 4


# copied from shm3d/ops/farfield.py (ShellPlan)
@dataclasses.dataclass(frozen=True)
class ShellPlan:
    """Host-precomputed shell decomposition for one (grid, sources, lam)."""

    shell_idx: np.ndarray      # (Qs,) int32 flat node ids with lam*d <= T
    shell_pos: np.ndarray      # (Qs, 3) float32 node positions
    coarse_pos: np.ndarray     # (m^3, 3) float32 coarse node positions
    # per-axis linear interpolation tables: fine coordinate -> coarse segment
    lo: np.ndarray             # (n,) int32 lower coarse index per fine index
    w: np.ndarray              # (n,) float32 weight of the upper coarse node
    m: int                     # coarse nodes per axis
    shell_fraction: float

    def arrays(self) -> dict:
        return {
            "shell_idx": self.shell_idx,
            "shell_pos": self.shell_pos,
            "coarse_pos": self.coarse_pos,
            "lo": self.lo,
            "w": self.w,
            "m": np.int64(self.m),
            "shell_fraction": np.float64(self.shell_fraction),
        }

    @staticmethod
    def from_arrays(arrays: dict) -> "ShellPlan":
        return ShellPlan(
            shell_idx=np.asarray(arrays["shell_idx"], np.int32),
            shell_pos=np.asarray(arrays["shell_pos"], np.float32),
            coarse_pos=np.asarray(arrays["coarse_pos"], np.float32),
            lo=np.asarray(arrays["lo"], np.int32),
            w=np.asarray(arrays["w"], np.float32),
            m=int(arrays["m"]),
            shell_fraction=float(arrays["shell_fraction"]),
        )


# copied from shm3d/ops/farfield.py (_EDT_MAX_RES)
_EDT_MAX_RES = 128


# copied from shm3d/ops/farfield.py (_node_dist_edt)
def _node_dist_edt(grid: GridSpec, src_points: np.ndarray):
    """((ne,ne,ne) distance field, edt_cell): distance from each EDT-raster
    cell to the nearest source-occupied raster cell center.  The raster is
    the node grid coarsened to <= _EDT_MAX_RES cells/axis; quantization is
    absorbed by the caller's margin."""
    from scipy import ndimage

    f = max(1, -(-grid.n // _EDT_MAX_RES))  # ceil(n / cap)
    ne = -(-grid.n // f)
    edt_cell = grid.cell_size * f
    cells = np.floor(
        (np.asarray(src_points, np.float64) - np.asarray(grid.bbox_min))
        / edt_cell
    ).astype(np.int64)
    np.clip(cells, 0, ne - 1, out=cells)
    occ = np.zeros((ne, ne, ne), dtype=bool)  # (z, y, x) = [k, j, i]
    occ[cells[:, 2], cells[:, 1], cells[:, 0]] = True
    return ndimage.distance_transform_edt(~occ, sampling=edt_cell), edt_cell, f


# copied from shm3d/ops/farfield.py (_positions_of)
def _positions_of(flat_idx: np.ndarray, grid: GridSpec) -> np.ndarray:
    """(Q, 3) float32 node positions from flat ids (i + j*n + k*n^2) without
    materializing the full (N, 3) position array (slow-numpy host)."""
    n = grid.n
    i = flat_idx % n
    j = (flat_idx // n) % n
    k = flat_idx // (n * n)
    out = np.empty((flat_idx.shape[0], 3), np.float32)
    out[:, 0] = grid.bbox_min[0] + i * grid.cell_size
    out[:, 1] = grid.bbox_min[1] + j * grid.cell_size
    out[:, 2] = grid.bbox_min[2] + k * grid.cell_size
    return out


# copied from shm3d/ops/farfield.py (build_shell_plan)
def build_shell_plan(
    grid: GridSpec,
    src_points: np.ndarray,
    lam: float,
    shell_t: float = DEFAULT_SHELL_T,
    factor: int = DEFAULT_COARSE_FACTOR,
) -> ShellPlan:
    n = grid.n
    d, edt_cell, f = _node_dist_edt(grid, src_points)
    # margin: EDT distances are raster-cell-center to raster-cell-center; the
    # true point can be closer by a raster-cell diagonal, and a fine node is
    # up to half a diagonal from its raster cell's center
    margin = 2.0 * np.sqrt(3.0) * edt_cell
    shell_coarse = (lam * np.maximum(d - margin, 0.0)) <= shell_t  # (ne,)*3
    if f > 1:
        shell_mask = np.repeat(
            np.repeat(np.repeat(shell_coarse, f, axis=0), f, axis=1), f, axis=2
        )[:n, :n, :n]
    else:
        shell_mask = shell_coarse
    shell_idx = np.nonzero(shell_mask.reshape(-1))[0].astype(np.int32)
    # flat order is i + j*n + k*n^2 == C-order [k, j, i]
    shell_pos = _positions_of(shell_idx.astype(np.int64), grid)

    # coarse lattice: stride `factor`, always including the last node so the
    # interpolation never extrapolates
    idx = np.arange(0, n, factor)
    if idx[-1] != n - 1:
        idx = np.append(idx, n - 1)
    m = len(idx)
    ii, jj, kk = np.meshgrid(idx, idx, idx, indexing="ij")  # (z, y, x)
    flat = (kk + jj * n + ii * n * n).reshape(-1)  # [k,j,i] ordering
    coarse_pos = _positions_of(flat, grid)

    fine = np.arange(n)
    seg = np.clip(np.searchsorted(idx, fine, side="right") - 1, 0, m - 2)
    denom = (idx[seg + 1] - idx[seg]).astype(np.float64)
    w = ((fine - idx[seg]) / denom).astype(np.float32)
    return ShellPlan(
        shell_idx=shell_idx,
        shell_pos=shell_pos,
        coarse_pos=coarse_pos,
        lo=seg.astype(np.int32),
        w=w,
        m=m,
        shell_fraction=float(shell_idx.shape[0]) / float(n ** 3),
    )


def interp_matrix(lo: torch.Tensor, w: torch.Tensor, n: int, m: int,
                  dtype: torch.dtype) -> torch.Tensor:
    """The (n, m) matrix of the per-axis linear interpolation: row i holds
    1 - w[i] at lo[i] and w[i] at lo[i] + 1 (two distinct columns, so the
    accumulation adds each to 0)."""
    ar = torch.arange(n, device=lo.device)
    W = torch.zeros((n, m), dtype=dtype, device=lo.device)
    W.index_put_((ar, lo), (1.0 - w).to(dtype), accumulate=True)
    W.index_put_((ar, lo + 1), w.to(dtype), accumulate=True)
    return W


def assemble_shell_field(
    Y_coarse: torch.Tensor,   # (m^3, 3) normalized directions at coarse nodes
    Y_shell: torch.Tensor,    # (Qs, 3) exact directions at shell nodes
    shell_idx: torch.Tensor,  # (Qs,) int64
    W: torch.Tensor,          # (n, m) interp_matrix of the plan's lo and w
    n: int,
    m: int,
) -> torch.Tensor:
    """Trilinear direction upsample + renormalize, then overwrite the shell
    rows with the exact kernel values.  Returns (n^3, 3) in flat node order.
    The separable interpolation is three dense (n, m) products with ``W``
    (``DeviceShellPlan`` builds it once)."""
    dtype = Y_coarse.dtype
    Yc = Y_coarse.reshape(m, m, m, 3)
    up = torch.einsum("zi,ijkc->zjkc", W, Yc)
    up = torch.einsum("yj,zjkc->zykc", W, up)
    up = torch.einsum("xk,zykc->zyxc", W, up)
    nrm = torch.linalg.vector_norm(up, dim=-1, keepdim=True)
    up = up / torch.clamp_min(nrm, torch.finfo(dtype).tiny)
    Y = up.reshape(n * n * n, 3)
    return Y.index_copy_(0, shell_idx, Y_shell)


class DeviceShellPlan:
    """ShellPlan tensors resident on ``device``, positions in the compute
    dtype (cached across warm solves)."""

    def __init__(self, plan: ShellPlan, device, dtype: torch.dtype):
        self.shell_idx = torch.as_tensor(plan.shell_idx, dtype=torch.int64, device=device)
        # float32 node coordinates are exact in the wider dtypes
        self.shell_pos = torch.as_tensor(plan.shell_pos, device=device).to(dtype)
        self.coarse_pos = torch.as_tensor(plan.coarse_pos, device=device).to(dtype)
        self.lo = torch.as_tensor(plan.lo, dtype=torch.int64, device=device)
        self.w = torch.as_tensor(plan.w, device=device)
        self.m = plan.m
        self.shell_fraction = plan.shell_fraction
        # the interpolation matrix depends on the plan alone: built once,
        # outside every solve (and its graph: index_put_'s accumulation sorts)
        self.W = interp_matrix(self.lo, self.w, int(self.lo.shape[0]), self.m, dtype)

    @classmethod
    def from_arrays(cls, arrays: dict, device, dtype: torch.dtype) -> "DeviceShellPlan":
        """From ``ShellPlan.arrays()`` of either package (the same format)."""
        return cls(ShellPlan.from_arrays(arrays), device, dtype)


def row_blocks(n_rows: int, n_shards: int, dtype: torch.dtype) -> int:
    """Rows a shard takes in ``_rowsharded`` for ``dtype`` queries: an equal
    share rounded up to that kernel's query block (the last shards take the
    rest, maybe none)."""
    block = query_block(dtype)
    return -(-n_rows // (n_shards * block)) * block


def _rowsharded(queries, src_points, src_vectors, lam, mesh) -> torch.Tensor:
    """The dense kernel with query ROWS split over the shards of ``mesh`` and
    the sources replicated (they are small for every configuration: <= 52k
    points; the ring schedule in shm3d_torch.parallel is for source counts
    that do not fit a device).  Each shard makes one plain single-device
    kernel call on its rows, and the rows are gathered back onto the first
    device in order.  The rows split at multiples of the kernel's query
    block and every call takes the whole launch's source chunks, so the
    field is bitwise equal to one launch over all rows.  The query block
    and the chunk length are those of the queries' dtype."""
    step = row_blocks(queries.shape[0], len(mesh), queries.dtype)
    chunk = (yukawa_chunk_len(queries.shape[0], src_points.shape[0], queries.device,
                              queries.dtype)
             if queries.device.type == "cuda" else None)
    out = [yukawa_field(queries[k * step:(k + 1) * step].to(dev), p, v, lam, chunk=chunk)
           for k, (dev, p, v) in enumerate(zip(mesh.devices, broadcast(src_points, mesh),
                                               broadcast(src_vectors, mesh)))]
    return torch.cat([o.to(mesh.first) for o in out])


def yukawa_field_shell(
    plan: DeviceShellPlan,
    src_points: torch.Tensor,
    src_vectors: torch.Tensor,
    lam,
    grid_n: int,
    mesh=None,
    chunks=(None, None),
):
    """Shell-decomposed Steps 1-2: the Yukawa kernel on the coarse lattice
    and the shell nodes, then the interpolated assembly (n^3, 3).  With a
    ``mesh`` (shm3d_torch.parallel.device_mesh) both launches are split by
    rows over its shards (``_rowsharded``) and the field, bitwise equal to
    the single-device one, is returned as its z-slabs (``Shards``).
    ``chunks``: the kernel's source chunks of the coarse and the shell
    launch on one device (``yukawa_chunk_len``, the default; given, the
    call makes no occupancy query, as a CUDA graph's capture needs)."""
    if mesh is None:
        Y_coarse = yukawa_field(plan.coarse_pos, src_points, src_vectors, lam, chunk=chunks[0])
        Y_shell = yukawa_field(plan.shell_pos, src_points, src_vectors, lam, chunk=chunks[1])
    else:
        Y_coarse = _rowsharded(plan.coarse_pos, src_points, src_vectors, lam, mesh)
        Y_shell = _rowsharded(plan.shell_pos, src_points, src_vectors, lam, mesh)
    Y = assemble_shell_field(Y_coarse, Y_shell, plan.shell_idx, plan.W, grid_n, plan.m)
    return Y if mesh is None else shard_rows(Y, mesh)
