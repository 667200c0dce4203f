"""Preconditioned conjugate gradients on flat tensors (port of ``cg`` in
shm3d.solve.krylov).

Eager PyTorch needs no ``while_loop``: the iteration is a Python loop whose
convergence test reads one scalar per iteration from the device.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch


class SolveResult(NamedTuple):
    x: torch.Tensor
    iterations: int
    residual: float  # final preconditioned residual norm sqrt(|r^T M r|)


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
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - matvec(x)
    z = M(r)
    rz = torch.dot(r, z)
    if rhs_mnorm is None:
        rhs_mnorm = math.sqrt(abs(float(torch.dot(b, M(b)))))
    threshold = tol * max(rhs_mnorm, torch.finfo(b.dtype).tiny)
    window = maxiter + 1 if stall_window is None else stall_window
    rn = math.sqrt(abs(float(rz)))
    best, since, k = rn, 0, 0
    p = z
    while rn > threshold and k < maxiter and since < window:
        Ap = matvec(p)
        alpha = rz / torch.dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new = torch.dot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
        rn = math.sqrt(abs(float(rz)))  # the one host sync per iteration
        since = 0 if rn < 0.98 * best else since + 1
        best = min(best, rn)
        k += 1
    return SolveResult(x, k, rn)
