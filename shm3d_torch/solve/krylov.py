"""Preconditioned conjugate gradients and MINRES (ports of ``cg`` and
``minres`` in shm3d.solve.krylov).

Eager PyTorch needs no ``while_loop``: each iteration is a Python loop
whose convergence test reads its scalars from the device once.  The vectors
are flat tensors or, on a device mesh, their z-slabs (``Shards``); MINRES
also takes the grid's KKT pairs (``solvers.grid.KKTPair``).  Anything with
``+``, ``-``, scalar ``*`` and ``/``, ``dot`` and ``zeros_like`` will do.

``cg`` and ``minres`` are the eager loops: the plain version, which the
CPU and the device mesh run.  ``cg_run`` and ``minres_run`` split the same
loops into a setup (``cg_start``, ``minres_start``, the eager ops of the
loop's first lines), an iteration body that reads and writes a fixed set
of state tensors in place (``cg_body``, ``minres_body``: the loop body's
ops in its order, then ``copy_`` into the state), and the same host stop
test.  A ``runner`` (``graphs.runner``) holds the state and steps the body:
on one CUDA device one replay of a CUDA graph an iteration, so the results
are the eager loop's bit for bit.  Vectors there also need ``clone`` and
``copy_``.
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


# --- the loops as setup, in-place body and host stop test -------------------


def cg_start(matvec, b, x0, M) -> dict:
    """``cg``'s setup: the state x, r, z, p and rz before its first
    iteration (p is z; the runner copies the state into buffers of its
    own)."""
    x = zeros_like(b) if x0 is None else x0
    r = b - matvec(x)
    z = M(r)
    return dict(x=x, r=r, z=z, p=z, rz=dot(r, z))


def cg_body(matvec, M, s: dict) -> None:
    """One iteration of ``cg`` on the state ``s`` in place: the loop body's
    ops in their order, then ``copy_`` into the state."""
    Ap = matvec(s["p"])
    alpha = s["rz"] / dot(s["p"], Ap)
    x = s["x"] + alpha * s["p"]
    r = s["r"] - alpha * Ap
    z = M(r)
    rz_new = dot(r, z)
    p = z + (rz_new / s["rz"]) * s["p"]
    for k, v in (("x", x), ("r", r), ("z", z), ("p", p), ("rz", rz_new)):
        s[k].copy_(v)


def cg_run(
    matvec: Callable,
    b,
    x0=None,
    precond: Optional[Callable] = None,
    tol: float = 1e-8,
    maxiter: int = 1000,
    rhs_mnorm: Optional[float] = None,
    stall_window: Optional[int] = None,
    runner=None,
) -> SolveResult:
    """``cg`` with its iteration stepped by ``runner`` (``graphs.runner``:
    a CUDA graph of ``cg_body`` replayed once an iteration); ``runner``
    None runs the eager ``cg``.  The same stop test, the same results."""
    if runner is None:
        return cg(matvec, b, x0=x0, precond=precond, tol=tol, maxiter=maxiter,
                  rhs_mnorm=rhs_mnorm, stall_window=stall_window)
    M = precond if precond is not None else (lambda r: r)
    init = cg_start(matvec, b, x0, M)
    if rhs_mnorm is None:
        rhs_mnorm = math.sqrt(abs(float(dot(b, M(b)))))
    threshold = tol * max(rhs_mnorm, torch.finfo(b.dtype).tiny)
    window = maxiter + 1 if stall_window is None else stall_window
    rn = math.sqrt(abs(float(init["rz"])))
    stepper = runner(init, lambda s: (lambda: cg_body(matvec, M, s),))
    s = stepper.state
    best, since, k = rn, 0, 0
    while rn > threshold and k < maxiter and since < window:
        stepper.step(0)
        rn = math.sqrt(abs(float(s["rz"])))  # the one host sync per iteration
        since = 0 if rn < 0.98 * best else since + 1
        best = min(best, rn)
        k += 1
    return SolveResult(s["x"].clone(), k, rn)


def minres_start(matvec, b, x0, M, tol: float, rhs_mnorm=None):
    """``minres``'s setup: (the state before its first iteration, the stop
    threshold, eps).  The state holds the vectors x, r1, r2, y, w, w2, the
    0-dim scalars oldb, beta, dbar, epsln, phibar, cs, sn, and ``stop``,
    (phibar, beta) for the host's stop test."""
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
    state = dict(x=x, r1=r1, r2=r1, y=y, w=zeros_like(b), w2=zeros_like(b),
                 oldb=zero, beta=beta1, dbar=zero, epsln=zero, phibar=beta1,
                 cs=beta1.new_full((), -1.0), sn=zero, stop=torch.stack([beta1, beta1]))
    return state, threshold, eps


def minres_body(matvec, M, s: dict, first: bool, eps: float) -> None:
    """One iteration of ``minres`` on the state ``s`` in place (``first``:
    its iteration 0, which has no previous Lanczos vector): the loop body's
    ops in their order, then ``copy_`` into the state, each buffer read
    before it is overwritten (r1 takes r2, w2 takes w, oldb takes beta)."""
    v = s["y"] / s["beta"]
    y = matvec(v)
    if not first:
        y = y - (s["beta"] / s["oldb"]) * s["r1"]
    alfa = dot(v, y)
    y = y - (alfa / s["beta"]) * s["r2"]
    r2 = y
    y = M(r2)
    beta = torch.sqrt(torch.abs(dot(r2, y)))

    delta = s["cs"] * s["dbar"] + s["sn"] * alfa
    gbar = s["sn"] * s["dbar"] - s["cs"] * alfa
    epsln = s["sn"] * beta
    dbar = -s["cs"] * beta
    gamma = torch.clamp_min(torch.sqrt(gbar * gbar + beta * beta), eps)
    cs = gbar / gamma
    sn = beta / gamma
    phi = cs * s["phibar"]
    phibar = sn * s["phibar"]

    w = (v - s["epsln"] * s["w2"] - delta * s["w"]) / gamma
    x = s["x"] + phi * w
    stop = torch.stack([phibar, beta])
    for k, src in (("r1", s["r2"]), ("r2", r2), ("w2", s["w"]), ("w", w),
                   ("oldb", s["beta"]), ("beta", beta), ("x", x), ("y", y),
                   ("epsln", epsln), ("dbar", dbar), ("cs", cs), ("sn", sn),
                   ("phibar", phibar), ("stop", stop)):
        s[k].copy_(src)


def minres_run(
    matvec: Callable,
    b,
    x0=None,
    precond: Optional[Callable] = None,
    tol: float = 1e-8,
    maxiter: int = 2000,
    rhs_mnorm=None,
    runner=None,
) -> SolveResult:
    """``minres`` with its iteration stepped by ``runner`` (two CUDA graphs
    of ``minres_body``: iteration 0 and the rest, one replay an iteration);
    ``runner`` None runs the eager ``minres``.  The same stop test, the same
    results."""
    if runner is None:
        return minres(matvec, b, x0=x0, precond=precond, tol=tol, maxiter=maxiter,
                      rhs_mnorm=rhs_mnorm)
    M = precond if precond is not None else (lambda r: r)
    init, threshold, eps = minres_start(matvec, b, x0, M, tol, rhs_mnorm)
    stepper = runner(init, lambda s: (lambda: minres_body(matvec, M, s, True, eps),
                                      lambda: minres_body(matvec, M, s, False, eps)))
    s = stepper.state
    k = 0
    phibar_h, beta_h = s["stop"].tolist()
    while phibar_h > threshold and k < maxiter and beta_h > 0:
        stepper.step(0 if k == 0 else 1)
        k += 1
        phibar_h, beta_h = s["stop"].tolist()  # the one host sync
    return SolveResult(s["x"].clone(), k, phibar_h)
