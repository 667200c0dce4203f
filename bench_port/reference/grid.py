"""Plain reference of the grid domain (``SignedHeatSolver("grid")``) for an
oriented point cloud: the same discretization, solved exactly.

Host (frozen copies): the point cloud's dual-area quadrature, the grid, the
shell decomposition's plan (its EDT sees the sources as float32 holds them,
as the program's does), one trilinear constraint row per occupied cell and
the sources' trilinear rows.  Card, in float64: the Yukawa field at the
shell nodes and the coarse lattice (``common.yukawa_unit``), its trilinear
upsampling renormalized with the shell rows overwritten, the adjoint
divergence, and Step 3 as the constrained least-squares problem itself:
min |grad u - Y|^2 subject to A u = 0, by conjugate gradient on
P H P u = P b (H = -L, the mirrored 7-point Laplacian) with the exact
projector P = I - A^T (A A^T)^{-1} A from a dense Cholesky factor of the
Gram matrix; phi = -u less its weighted mean along the sources.
"""

from __future__ import annotations

import math
import time
from pathlib import Path
from typing import Optional

import numpy as np
import scipy.sparse as sp
import torch
import torch.nn.functional as F

from . import common
from .frozen import grid as griddom
from .frozen import pointcloud
from .frozen import shellplan

# the reference's own cache of derived inputs, inside the checkout
CACHE = Path(__file__).resolve().parents[1] / "_cache" / "reference"
DEFAULTS = dict(h_coef=0.0, scale=2.0, t_coef=1.0, shell_t=8.0, shell_coarse_factor=4,
                step1_method="auto", shell_auto_n=128)
TOL = {torch.float64: 1e-12, torch.float32: 1e-6, torch.bfloat16: 4e-3}
MAXITER = 20000


def discretize(inputs: dict, opts: dict, port: Optional[dict] = None) -> dict:
    """The host half: quadrature, grid, plan and rows (NumPy, float64);
    nothing of the program's output (``port``) is read."""
    o = {**DEFAULTS, **{k: v for k, v in opts.items() if k in DEFAULTS}}
    pos = np.asarray(inputs["positions"], np.float64)
    nrm = np.asarray(inputs["normals"], np.float64)
    dual_areas, mean_edge = quadrature(pos)
    normals = nrm / np.linalg.norm(nrm, axis=1, keepdims=True)
    grid = griddom.build_grid(pos, o["scale"], o["h_coef"])
    lam = math.sqrt(1.0 / (o["t_coef"] * mean_edge ** 2))
    plan = shellplan.build_shell_plan(
        grid, pos.astype(np.float32).astype(np.float64), lam, o["shell_t"],
        o["shell_coarse_factor"])
    nodes8, coeffs8 = griddom.constraint_rows(grid, pos)
    src_nodes8, src_coeffs8 = griddom.trilinear_rows(grid, pos)
    use_shell = (o["step1_method"] == "shell"
                 or (o["step1_method"] == "auto" and grid.n >= o["shell_auto_n"]))
    return dict(use_shell=use_shell, factor=o["shell_coarse_factor"], points=pos, vectors=normals * dual_areas[:, None],
                weights=dual_areas, grid=grid, lam=lam, plan=plan,
                nodes8=nodes8, coeffs8=coeffs8, src_nodes8=src_nodes8,
                src_coeffs8=src_coeffs8)


def quadrature(pos: np.ndarray):
    """(dual areas, mean edge length) of the point cloud's local
    triangulation (frozen copy), ~30 s of host time for 52k points; kept in
    the checkout under a key of the positions' bytes, so that a cloud seen
    before is read back instead of derived again (the same numbers)."""
    import hashlib
    import os
    import tempfile

    key = hashlib.sha256(np.ascontiguousarray(pos).tobytes()).hexdigest()[:24]
    path = CACHE / f"quadrature_{key}.npz"
    if path.exists():
        with np.load(path) as z:
            return z["dual_areas"], float(z["mean_edge_length"])
    tri = pointcloud.local_triangulation(pos, pointcloud._K_NEIGHBORS)
    CACHE.mkdir(parents=True, exist_ok=True)
    with tempfile.NamedTemporaryFile(dir=CACHE, suffix=".npz", delete=False) as f:
        np.savez(f, dual_areas=tri.dual_areas, mean_edge_length=tri.mean_edge_length)
    os.replace(f.name, path)
    return tri.dual_areas, float(tri.mean_edge_length)


def node_positions(grid, flat: np.ndarray) -> np.ndarray:
    n = grid.n
    ijk = np.stack([flat % n, (flat // n) % n, flat // (n * n)], axis=1)
    return np.asarray(grid.bbox_min)[None, :] + ijk * grid.cell_size


def upsample(Yc: torch.Tensor, lo: np.ndarray, w: np.ndarray, n: int, m: int) -> torch.Tensor:
    """Trilinear upsampling of the coarse lattice's (m^3, 3) field to
    (n^3, 3), renormalized."""
    dt, dev = Yc.dtype, Yc.device
    W = torch.zeros((n, m), dtype=dt, device=dev)
    rows = torch.arange(n, device=dev)
    lo_t = torch.as_tensor(lo, dtype=torch.int64, device=dev)
    w_t = torch.as_tensor(np.asarray(w, np.float64), dtype=dt, device=dev)
    W[rows, lo_t] = 1.0 - w_t
    W[rows, lo_t + 1] = w_t
    up = torch.einsum("zi,ijkc->zjkc", W, Yc.reshape(m, m, m, 3))
    up = torch.einsum("yj,zjkc->zykc", W, up)
    up = torch.einsum("xk,zykc->zyxc", W, up)
    up = up / torch.linalg.vector_norm(up, dim=-1, keepdim=True)
    return up.reshape(n * n * n, 3)


def laplacian(u3: torch.Tensor, cell: float) -> torch.Tensor:
    """The 7-point Laplacian with mirrored boundary differences (a
    neighbour past the boundary is the node itself), on (n, n, n)."""
    p = F.pad(u3[None, None], (1, 1, 1, 1, 1, 1), mode="replicate")[0, 0]
    acc = (p[2:, 1:-1, 1:-1] + p[:-2, 1:-1, 1:-1] + p[1:-1, 2:, 1:-1]
           + p[1:-1, :-2, 1:-1] + p[1:-1, 1:-1, 2:] + p[1:-1, 1:-1, :-2]) - 6.0 * u3
    return acc / (cell * cell)


def divergence(Y3: torch.Tensor, cell: float) -> torch.Tensor:
    """The adjoint of the forward-difference gradient (mirrored at the far
    boundary: the last difference is the backward one), on (n, n, n, 3)
    with component c differentiated along axis 2 - c."""
    out = torch.zeros(Y3.shape[:3], dtype=Y3.dtype, device=Y3.device)
    for comp, axis in ((0, 2), (1, 1), (2, 0)):
        g = (Y3[..., comp] / cell).movedim(axis, 0)
        acc = torch.zeros_like(g)
        acc[1:] += g[:-1]
        acc[:-1] -= g[:-1]
        acc[-1] += g[-1]
        acc[-2] -= g[-1]
        out += acc.movedim(0, axis)
    return out


def solve(inputs: dict, opts: dict, device, control: Optional[str] = None,
          disc: Optional[dict] = None, port: Optional[dict] = None) -> dict:
    """The reference's solve of ``inputs`` (in float64, or in a control's
    precision); ``disc``: the host half already made by ``discretize``."""
    t0 = time.perf_counter()
    d = discretize(inputs, opts) if disc is None else disc
    t_host = time.perf_counter() - t0
    grid, plan = d["grid"], d["plan"]
    n, N, cell = grid.n, grid.total_nodes, float(grid.cell_size)
    with common.precision(control) as dt:
        put = lambda a, t=dt: torch.as_tensor(np.asarray(a), device=device).to(t)
        pts, vecs = put(d["points"]), put(d["vectors"])
        if d["use_shell"]:
            shell_idx = plan.shell_idx.astype(np.int64)
            coarse_flat = _coarse_flat(n, int(d["factor"]), plan.m)
            Y_shell = common.yukawa_unit(put(node_positions(grid, shell_idx)), pts, vecs,
                                         d["lam"])
            Y_coarse = common.yukawa_unit(put(node_positions(grid, coarse_flat)), pts, vecs,
                                          d["lam"])
            Y = upsample(Y_coarse, plan.lo, plan.w, n, plan.m)
            Y[torch.as_tensor(shell_idx, device=device)] = Y_shell
            del Y_shell, Y_coarse
        else:
            # the dense Step 1: every node exact (the "shell" is the grid)
            shell_idx = np.arange(N, dtype=np.int64)
            coarse_flat = shell_idx[:0]
            Y = common.yukawa_unit(put(node_positions(grid, shell_idx)), pts, vecs, d["lam"])
        b = -divergence(Y.reshape(n, n, n, 3), cell).reshape(-1)

        nodes8 = torch.as_tensor(d["nodes8"], dtype=torch.int64, device=device)
        c8 = put(d["coeffs8"])
        m = nodes8.shape[0]
        A = sp.csr_matrix((d["coeffs8"].reshape(-1),
                           (np.repeat(np.arange(m), 8), d["nodes8"].reshape(-1))),
                          shape=(m, N))
        G = (A @ A.T).tocoo()
        fdt = common.factor_dtype(dt)
        Gd = torch.zeros((m, m), dtype=fdt, device=device)
        Gd[torch.as_tensor(G.row, device=device), torch.as_tensor(G.col, device=device)] = \
            put(G.data, fdt)
        L, info = torch.linalg.cholesky_ex(Gd)
        if int(info) != 0:
            raise FloatingPointError(f"the Gram matrix's Cholesky factor broke down in {fdt}")
        Ginv = torch.cholesky_inverse(L).to(dt)
        del Gd, L

        flat8 = nodes8.reshape(-1)
        a_of = lambda v: (v[nodes8] * c8).sum(dim=1)
        at_of = lambda z: torch.zeros(N, dtype=dt, device=device).index_add_(
            0, flat8, (z[:, None] * c8).reshape(-1))

        def project(v):
            # one step of iterative refinement on the Gram solve: without
            # it the rounding of the inverse (cond ~1e5-1e6) leaves the
            # iterates drifting out of ker(A) and CG stalls near 1e-10
            a = a_of(v)
            z = Ginv @ a
            z = z + Ginv @ (a - a_of(at_of(z)))
            return v - at_of(z)

        Pb = project(b)
        u, iters, rel = common.cg(
            lambda v: project(-laplacian(v.reshape(n, n, n), cell).reshape(-1)),
            Pb, TOL[dt], MAXITER)
        phi = -u
        src = torch.as_tensor(d["src_nodes8"], dtype=torch.int64, device=device)
        w = put(d["weights"])
        vals = (phi[src] * put(d["src_coeffs8"])).sum(dim=1)
        phi = phi - (w * vals).sum() / w.sum()
        out = dict(Y=Y.double().cpu().numpy(), phi=phi.double().cpu().numpy(),
                   shell_idx=shell_idx)
    out["info"] = dict(
        n_sources=int(d["points"].shape[0]), shell_nodes=int(shell_idx.shape[0]),
        coarse_nodes=int(coarse_flat.shape[0]),
        k1_queries=int(shell_idx.shape[0] + coarse_flat.shape[0]), m_rows=int(m), iters=int(iters),
        rel_res=float(rel), host_s=t_host, total_s=time.perf_counter() - t0)
    return out


def _coarse_flat(n: int, factor: int, m: int) -> np.ndarray:
    """Flat ids of the coarse lattice's nodes in the plan's order: stride
    ``factor`` along each axis, and always the last node."""
    idx = np.arange(0, n, factor)
    if idx[-1] != n - 1:
        idx = np.append(idx, n - 1)
    if idx.shape[0] != m:
        raise ValueError(f"coarse lattice of {idx.shape[0]} nodes an axis, the plan has {m}")
    ii, jj, kk = np.meshgrid(idx, idx, idx, indexing="ij")
    return (kk + jj * n + ii * n * n).reshape(-1).astype(np.int64)


def numbers(port: dict, ref: dict) -> dict:
    """The program's solve against the reference: the unit field's root
    mean square error over all nodes and its largest error over the shell
    nodes (where the kernel is exact), phi's relative L2 error and its
    largest error relative to the largest |phi|."""
    dY = np.linalg.norm(np.asarray(port["Y"], np.float64) - ref["Y"], axis=1)
    dphi = np.asarray(port["phi"], np.float64) - ref["phi"]
    return {
        "y_rms": float(np.sqrt(np.mean(dY ** 2))),
        "y_shell_max": float(dY[ref["shell_idx"]].max()),
        "phi_rel": float(np.linalg.norm(dphi) / np.linalg.norm(ref["phi"])),
        "phi_max": float(np.abs(dphi).max() / np.abs(ref["phi"]).max()),
    }
