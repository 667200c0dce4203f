"""Arithmetic shared by the references: precision, the Yukawa sum, a plain
conjugate gradient."""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch

# the control: every array and product of the reference in bfloat16 (the
# precision below float32 for work that is not a tensor-core product); a
# second reading: float32 with TF32 products
CONTROLS = (None, "bf16", "tf32")
DTYPES = {None: torch.float64, "bf16": torch.bfloat16, "tf32": torch.float32}


@contextlib.contextmanager
def precision(control: Optional[str]):
    """The dtype of a reference run, TF32 set for its duration: float64
    with TF32 off; for a control, bfloat16 (TF32 off) or float32 with TF32
    products."""
    if control not in CONTROLS:
        raise ValueError(f"control={control!r}; expected one of {CONTROLS}")
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    tf32 = control == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield DTYPES[control]
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def factor_dtype(dt: torch.dtype) -> torch.dtype:
    """The dtype a factorization runs in: bfloat16 has none, so its
    factors are made in float32 and stored in bfloat16."""
    return torch.float32 if dt == torch.bfloat16 else dt


def yukawa_unit(queries: torch.Tensor, points: torch.Tensor, vectors: torch.Tensor,
                lam: float, block: int = 2048) -> torch.Tensor:
    """Steps 1-2: X(q) = sum_s v_s exp(-lam r) / r, r = |q - p_s|, and
    X / |X|, for every query, as a kernel matrix times the source vectors.
    Each query's exponents are taken relative to its least lam r (the
    direction does not change), so no far query underflows.  The source
    vectors are padded to 8 columns, zeros past the third, a width the
    tensor cores take."""
    dt = queries.dtype
    S = points.shape[0]
    V = torch.zeros((S, 8), dtype=dt, device=queries.device)
    V[:, :3] = vectors
    out = torch.empty((queries.shape[0], 3), dtype=dt, device=queries.device)
    for i in range(0, queries.shape[0], block):
        q = queries[i:i + block]
        # a query on a source would divide by zero: the clamp keeps the
        # coincident source dominant
        r = torch.sqrt(torch.clamp_min((q[:, 0:1] - points[None, :, 0]) ** 2
                                       + (q[:, 1:2] - points[None, :, 1]) ** 2
                                       + (q[:, 2:3] - points[None, :, 2]) ** 2,
                                       torch.finfo(dt).tiny))
        lr = lam * r
        K = torch.exp(lr.amin(dim=1, keepdim=True) - lr) / r
        X = (K @ V)[:, :3]
        out[i:i + block] = X / torch.linalg.vector_norm(X, dim=1, keepdim=True)
    return out


def cg(matvec: Callable, b: torch.Tensor, tol: float, maxiter: int,
       precond: Callable = None, check_every: int = 25,
       stall_checks: int = 20) -> Tuple[torch.Tensor, int, float]:
    """Plain (preconditioned) conjugate gradient from zero to
    ||r|| <= tol ||b||, checked every ``check_every`` iterations; it stops
    too where ``stall_checks`` checks in a row bring the residual no lower
    than 0.98 of the best (a precision's floor).  A direction or residual
    that vanishes exactly ends the recurrence without dividing by zero.
    Returns (x, iterations, ||r|| / ||b||)."""
    M = precond if precond is not None else (lambda r: r)
    x = torch.zeros_like(b)
    r = b.clone()
    z = M(r)
    p = z.clone()
    rz = torch.dot(r, z)
    bnorm = float(torch.linalg.vector_norm(b.float() if b.dtype == torch.bfloat16 else b))
    if bnorm == 0.0:
        return x, 0, 0.0
    it, rel, best, stalled = 0, 1.0, math.inf, 0
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    while it < maxiter:
        Ap = matvec(p)
        pAp = torch.dot(p, Ap)
        alpha = torch.where(pAp != 0, rz / pAp, zero)
        x += alpha * p
        r -= alpha * Ap
        z = M(r)
        rz_new = torch.dot(r, z)
        p = z + torch.where(rz != 0, rz_new / rz, zero) * p
        rz = rz_new
        it += 1
        if it % check_every == 0 or it == maxiter:
            rel = float(torch.linalg.vector_norm(r.float() if r.dtype == torch.bfloat16
                                                 else r)) / bnorm
            if not np.isfinite(rel) or rel <= tol:
                break
            if rel < 0.98 * best:
                best, stalled = rel, 0
            else:
                stalled += 1
                if stalled >= stall_checks:
                    break
    return x, it, rel
