"""Preconditioned conjugate gradients and MINRES (ports of ``cg`` and
``minres`` in shm3d.solve.krylov).

Eager PyTorch needs no ``while_loop``: each iteration is a Python loop
whose convergence test reads its scalars from the device once.  The vectors
are flat tensors or, on a device mesh, their z-slabs (``Shards``); MINRES
also takes the grid's KKT pairs (``solvers.grid.KKTPair``).  Anything with
``+``, ``-``, scalar ``*`` and ``/``, ``dot`` and ``zeros_like`` will do.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch


class SolveResult(NamedTuple):
    x: torch.Tensor
    iterations: int
    # cg: the final preconditioned residual norm sqrt(|r^T M r|); minres:
    # its estimate phibar
    residual: float


def dot(a, b) -> torch.Tensor:
    """a . b: ``torch.dot``, or for z-slabs (``Shards``, and the pairs that
    hold them) the per-shard dots summed in shard order, so no reduction
    depends on timing."""
    return torch.dot(a, b) if isinstance(a, torch.Tensor) else a.dot(b)


def zeros_like(b):
    return torch.zeros_like(b) if isinstance(b, torch.Tensor) else b.zeros_like()


def cg(
    matvec: Callable,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    precond: Optional[Callable] = None,
    tol: float = 1e-8,
    maxiter: int = 1000,
    rhs_mnorm: Optional[float] = None,
    stall_window: Optional[int] = None,
) -> SolveResult:
    """Preconditioned CG for an SPD ``matvec``.

    Stops when sqrt(|r^T M r|) <= tol * ||b||_M; ``rhs_mnorm`` overrides
    ||b||_M.  ``stall_window``: also stop once the preconditioned residual
    has not improved by more than 2% for this many consecutive iterations
    (the dtype's roundoff floor)."""
    M = precond if precond is not None else (lambda r: r)
    x = zeros_like(b) if x0 is None else x0
    r = b - matvec(x)
    z = M(r)
    rz = dot(r, z)
    if rhs_mnorm is None:
        rhs_mnorm = math.sqrt(abs(float(dot(b, M(b)))))
    threshold = tol * max(rhs_mnorm, torch.finfo(b.dtype).tiny)
    window = maxiter + 1 if stall_window is None else stall_window
    rn = math.sqrt(abs(float(rz)))
    best, since, k = rn, 0, 0
    p = z
    while rn > threshold and k < maxiter and since < window:
        Ap = matvec(p)
        alpha = rz / dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new = dot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
        rn = math.sqrt(abs(float(rz)))  # the one host sync per iteration
        since = 0 if rn < 0.98 * best else since + 1
        best = min(best, rn)
        k += 1
    return SolveResult(x, k, rn)


def minres(
    matvec: Callable,
    b,
    x0=None,
    precond: Optional[Callable] = None,
    tol: float = 1e-8,
    maxiter: int = 2000,
    rhs_mnorm=None,
) -> SolveResult:
    """Preconditioned MINRES (Paige & Saunders 1975) for a symmetric,
    possibly indefinite ``matvec`` with an SPD preconditioner: shm3d's
    recurrences in its order, the scalars in the vectors' dtype on the
    device.

    Stops when phibar <= tol * max(ref, tiny), ref = ``rhs_mnorm`` (a number
    or a 0-dim tensor) or else the preconditioned norm of the first
    residual, after ``maxiter`` iterations, or when the Lanczos beta reaches
    0.  ``residual`` is the final phibar, an absolute estimate of the
    preconditioned residual norm (not divided by ref).  No stall stop and no
    restarts, as in shm3d: in float32 the iteration can stall near its
    roundoff floor until ``maxiter``."""
    M = precond if precond is not None else (lambda r: r)
    x = zeros_like(b) if x0 is None else x0
    r1 = b - matvec(x)
    y = M(r1)
    beta1 = torch.sqrt(torch.abs(dot(r1, y)))
    dtype = beta1.dtype
    eps = torch.finfo(dtype).eps
    ref = beta1 if rhs_mnorm is None else torch.as_tensor(rhs_mnorm, dtype=dtype,
                                                          device=beta1.device)
    threshold = float(tol * torch.clamp_min(ref, torch.finfo(dtype).tiny))
    zero = beta1.new_zeros(())
    r2, w, w2 = r1, zeros_like(b), zeros_like(b)
    oldb, beta, dbar, epsln, phibar = zero, beta1, zero, zero, beta1
    cs, sn = beta1.new_full((), -1.0), zero
    k = 0
    phibar_h, beta_h = torch.stack([phibar, beta]).tolist()
    while phibar_h > threshold and k < maxiter and beta_h > 0:
        v = y / beta
        y = matvec(v)
        if k >= 1:
            y = y - (beta / oldb) * r1
        alfa = dot(v, y)
        y = y - (alfa / beta) * r2
        r1, r2 = r2, y
        y = M(r2)
        oldb = beta
        beta = torch.sqrt(torch.abs(dot(r2, y)))

        oldeps = epsln
        delta = cs * dbar + sn * alfa
        gbar = sn * dbar - cs * alfa
        epsln = sn * beta
        dbar = -cs * beta
        gamma = torch.clamp_min(torch.sqrt(gbar * gbar + beta * beta), eps)
        cs = gbar / gamma
        sn = beta / gamma
        phi = cs * phibar
        phibar = sn * phibar

        w1, w2 = w2, w
        w = (v - oldeps * w1 - delta * w2) / gamma
        x = x + phi * w
        k += 1
        phibar_h, beta_h = torch.stack([phibar, beta]).tolist()  # the one host sync
    return SolveResult(x, k, phibar_h)
