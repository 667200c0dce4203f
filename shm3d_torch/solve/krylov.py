"""Preconditioned conjugate gradients and MINRES (ports of ``cg`` and
``minres`` in shm3d.solve.krylov).

Eager PyTorch needs no ``while_loop``: each iteration is a Python loop
whose convergence test reads its scalars from the device once.  The vectors
are flat tensors or, on a device mesh, their z-slabs (``Shards``); MINRES
also takes the grid's KKT pairs (``solvers.grid.KKTPair``).  Anything with
``+``, ``-``, scalar ``*`` and ``/``, ``dot`` and ``zeros_like`` will do.

``cg`` and ``minres`` are the eager loops: the plain version, which the
CPU and the device mesh run.  ``cg_run`` and ``minres_run`` split the same
loops into device programs, shm3d's ``while_loop`` on one card: a setup
(``cg_start``, ``minres_start``: the loop's first lines and rhs_mnorm, then
the stop state's start), and an iteration body that reads and writes a
fixed set of state tensors in place (``cg_body``, ``minres_body``: the
loop body's ops in its order, then ``copy_`` into the state) and ends in
the stop test on the device (``solve.stop``, the host test's arithmetic).
A ``runner`` (``graphs.runner``) holds the state and runs them: on one
CUDA device a setup graph and the bodies under conditional nodes until the
stop, the stop state read once a solve, so the results are the eager
loop's bit for bit.  Vectors there also need ``clone`` and ``copy_``.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from . import stop


class SolveResult(NamedTuple):
    x: torch.Tensor
    iterations: int
    # cg: the final preconditioned residual norm sqrt(|r^T M r|); minres:
    # its estimate phibar
    residual: float
    # cg: ||b||_M, the norm its threshold is relative to (the caller's
    # rhs_mnorm, or computed); minres: None
    rhs_mnorm: Optional[float] = None


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
    return SolveResult(x, k, rn, rhs_mnorm)


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


# --- the loops as device programs: setup, in-place body, device stop test --


def _chunked(runner, inputs: dict, setup, start, make_bodies, params, variant):
    """Run a solve on ``runner``'s stepper; returns (stepper, the stop state
    as floats).  A stepper whose first solve (its build) raised is not
    kept."""
    stepper = runner.get(setup, start, make_bodies, variant=variant)
    built = stepper.state is not None
    try:
        return stepper, stepper.solve(inputs, params, variant=variant)
    except Exception:
        if not built:
            runner.cache.pop(runner.key, None)
        raise


def cg_start(matvec, b, x0, M, rhs: bool = True) -> dict:
    """``cg``'s setup: the state x, r, z, p and rz before its first
    iteration (p is z; the runner copies the state into buffers of its
    own) and, with ``rhs``, bmb = b . M b, whose root is rhs_mnorm."""
    x = zeros_like(b) if x0 is None else x0
    r = b - matvec(x)
    z = M(r)
    state = dict(x=x, r=r, z=z, p=z, rz=dot(r, z))
    if rhs:
        state["bmb"] = dot(b, M(b))
    return state


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
    prep: Optional[Callable] = None,
) -> SolveResult:
    """``cg`` on ``prep(b)`` (``prep`` None: b) as device programs on
    ``runner`` (``graphs.runner``: the setup graph, then ``cg_body`` under a
    WHILE node on the device stop test, ``stop.cg_stop``); ``runner``
    None runs the eager ``cg``.  The same stop test, the same results; on
    the runner ``prep`` and rhs_mnorm run inside the setup."""
    if runner is None:
        b = b if prep is None else prep(b)
        return cg(matvec, b, x0=x0, precond=precond, tol=tol, maxiter=maxiter,
                  rhs_mnorm=rhs_mnorm, stall_window=stall_window)
    M = precond if precond is not None else (lambda r: r)
    dtype = b.dtype
    window = maxiter + 1 if stall_window is None else stall_window
    inputs = {"b": b} if x0 is None else {"b": b, "x0": x0}

    def setup(i):
        bb = i["b"] if prep is None else prep(i["b"])
        return cg_start(matvec, bb, i.get("x0"), M, rhs=rhs_mnorm is None)

    def start(s):
        stop.cg_stop(s["rz"], s.get("bmb"), s["stop"], s["go"], start=True)

    def make_bodies(s):
        def body():
            cg_body(matvec, M, s)
            stop.cg_stop(s["rz"], None, s["stop"], s["go"])
        return (body,)

    params = stop.params(tol, maxiter, window, torch.finfo(dtype).tiny,
                         None if rhs_mnorm is None else float(rhs_mnorm))
    stepper, host = _chunked(runner, inputs, setup, start, make_bodies, params,
                             ("cg", x0 is not None, rhs_mnorm is not None, prep is not None))
    return SolveResult(stepper.state["x"].clone(), int(host[stop.K]), host[stop.RN],
                       host[stop.RHS])


def minres_start(matvec, b, x0, M, ref=None) -> dict:
    """``minres``'s setup: the state before its first iteration, the
    vectors x, r1, r2, y, w, w2 and the 0-dim scalars oldb, beta, dbar,
    epsln, phibar, cs, sn, and ``ref``, the threshold's reference norm
    (``ref`` given, or else beta1)."""
    x = zeros_like(b) if x0 is None else x0
    r1 = b - matvec(x)
    y = M(r1)
    beta1 = torch.sqrt(torch.abs(dot(r1, y)))
    zero = beta1.new_zeros(())
    return dict(x=x, r1=r1, r2=r1, y=y, w=zeros_like(b), w2=zeros_like(b),
                oldb=zero, beta=beta1, dbar=zero, epsln=zero, phibar=beta1,
                cs=beta1.new_full((), -1.0), sn=zero, ref=beta1 if ref is None else ref)


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
    for k, src in (("r1", s["r2"]), ("r2", r2), ("w2", s["w"]), ("w", w),
                   ("oldb", s["beta"]), ("beta", beta), ("x", x), ("y", y),
                   ("epsln", epsln), ("dbar", dbar), ("cs", cs), ("sn", sn),
                   ("phibar", phibar)):
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
    prep: Optional[Callable] = None,
) -> SolveResult:
    """``minres`` on ``prep(b)`` as device programs on ``runner`` (the setup
    graph, then ``minres_body``'s iteration 0 under an IF node and the rest
    under a WHILE node, on the device stop test, ``stop.minres_stop``);
    ``runner`` None runs the eager ``minres``.  ``rhs_mnorm``: None (the
    first residual's norm), a number or 0-dim tensor, or a function of the
    right-hand side computing it (inside the setup on the runner).  The
    same stop test, the same results."""
    if runner is None:
        b = b if prep is None else prep(b)
        if callable(rhs_mnorm):
            rhs_mnorm = rhs_mnorm(b)
        return minres(matvec, b, x0=x0, precond=precond, tol=tol, maxiter=maxiter,
                      rhs_mnorm=rhs_mnorm)
    M = precond if precond is not None else (lambda r: r)
    inputs = {"b": b} if x0 is None else {"b": b, "x0": x0}
    given = rhs_mnorm is not None and not callable(rhs_mnorm)
    probe = b if isinstance(b, torch.Tensor) else b.u
    dtype = probe.dtype
    if given:
        inputs["ref"] = torch.as_tensor(rhs_mnorm, dtype=dtype, device=probe.device)
    eps = torch.finfo(dtype).eps

    def setup(i):
        bb = i["b"] if prep is None else prep(i["b"])
        ref = i["ref"] if given else (rhs_mnorm(bb) if callable(rhs_mnorm) else None)
        return minres_start(matvec, bb, i.get("x0"), M, ref)

    def start(s):
        stop.minres_stop(s["phibar"], s["beta"], s["ref"], s["stop"], s["go"], start=True)

    def make_bodies(s):
        def body(first):
            minres_body(matvec, M, s, first, eps)
            stop.minres_stop(s["phibar"], s["beta"], None, s["stop"], s["go"])
        return (lambda: body(True), lambda: body(False))

    params = stop.params(tol, maxiter, 0, torch.finfo(dtype).tiny)
    variant = ("minres", x0 is not None, "given" if given else callable(rhs_mnorm),
               prep is not None)
    stepper, host = _chunked(runner, inputs, setup, start, make_bodies, params, variant)
    return SolveResult(stepper.state["x"].clone(), int(host[stop.K]), host[stop.RN])
