"""Geometric multigrid preconditioner for the 7-point grid Laplacian (port
of shm3d.solve.multigrid).

Weighted Jacobi (omega = 2/3) on H = -L, separable full-weighting
restriction and cell-centred linear prolongation (its adjoint up to 1/8),
rediscretized coarse operators, and the dense pseudo-inverse or 40 Jacobi
sweeps on the coarsest level.  With pin masks every level smooths on
H + diag(mask * 6/cell^2), a Dirichlet penalty at the constraint surface
that makes the V-cycle close to the projected operator the outer CG solves.

All functions are out of place: no caller's tensor is modified.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops import stencil

_OMEGA = 2.0 / 3.0


# copied from shm3d/solve/multigrid.py (_coarse_pinv_unit)
@functools.lru_cache(maxsize=8)
def _coarse_pinv_unit(n: int) -> np.ndarray:
    """Dense pseudo-inverse of the unit-cell-size coarse operator H = -L on
    an (n, n, n) grid (mirrored boundaries), as a host float64 array.  The
    null constant mode is truncated, keeping the result symmetric PSD (a
    valid MINRES/CG preconditioner block)."""
    from ..domains import grid as griddom

    spec = griddom.GridSpec((0.0, 0.0, 0.0), 1.0, n)
    H = -griddom.laplacian_matrix(spec).toarray()
    lam, Q = np.linalg.eigh(H)
    inv = np.where(lam > 1e-8 * lam[-1], 1.0 / np.maximum(lam, 1e-300), 0.0)
    return (Q * inv) @ Q.T


@functools.lru_cache(maxsize=8)
def _coarse_pinv(n: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``_coarse_pinv_unit`` resident on ``device`` (copied there once)."""
    return torch.as_tensor(_coarse_pinv_unit(n), dtype=dtype, device=device)


def _Hp_apply(u, cell, w):
    """H + diag(w): the penalized operator the pin-aware V-cycle targets
    (``w`` None -> plain H)."""
    r = -stencil.laplacian_apply(u, cell)
    return r if w is None else r + w * u


def _H_diag(cell):
    """Constant interior diagonal 6/cell^2 (the exact boundary-corrected
    diagonal would make the smoother non-self-adjoint)."""
    return 6.0 / (cell * cell)


def _jacobi(u, b, cell, diag, sweeps: int, w=None):
    d = diag if w is None else diag + w
    for _ in range(sweeps):
        u = u + _OMEGA * (b - _Hp_apply(u, cell, w)) / d
    return u


def restrict(r: torch.Tensor) -> torch.Tensor:
    """(n, n, n) -> (n/2, n/2, n/2): adjoint of ``prolong`` scaled by 1/8
    (separable full weighting; constants restrict to constants)."""
    for ax in range(3):
        r = r.movedim(ax, 0)
        even, odd = r[0::2], r[1::2]
        c = 0.75 * (even + odd)  # a new tensor: the updates below are local
        c[1:] += 0.25 * odd[:-1]
        c[:-1] += 0.25 * even[1:]
        # clamped-boundary contributions (mirror of the prolongation clamp)
        c[0] += 0.25 * even[0]
        c[-1] += 0.25 * odd[-1]
        r = (0.5 * c).movedim(0, ax)
    return r.contiguous()


def prolong(e: torch.Tensor) -> torch.Tensor:
    """(m, m, m) -> (2m, 2m, 2m) separable cell-centred linear interpolation
    (weights 3/4, 1/4; clamped at the mirrored boundaries)."""
    for ax in range(3):
        e = e.movedim(ax, 0)
        m = e.shape[0]
        left = torch.cat([e[:1], e[:-1]], dim=0)
        right = torch.cat([e[1:], e[-1:]], dim=0)
        out = torch.empty((2 * m,) + tuple(e.shape[1:]), dtype=e.dtype, device=e.device)
        out[0::2] = 0.75 * e + 0.25 * left
        out[1::2] = 0.75 * e + 0.25 * right
        e = out.movedim(0, ax)
    return e.contiguous()


def v_cycle(b: torch.Tensor, cell: float, nu: int = 1, coarsest: int = 8, pins=None):
    """One symmetric V-cycle approximating H^{-1} b, H = -L at spacing
    ``cell``; ``b`` is (n, n, n).  ``pins``: optional tuple of per-level
    penalty masks in [0, 1] (level 0 first; ``build_pin_masks``)."""
    n = b.shape[0]
    w = None
    if pins is not None and len(pins) > 0:
        w = pins[0] * (6.0 / (cell * cell))
        pins_c = pins[1:]
    else:
        pins_c = None if pins is None else ()
    if n <= coarsest:
        if n <= 16 and w is None:  # dense pinv: 16^3 -> a 4096^2 matvec
            pinv = _coarse_pinv(n, b.dtype, b.device)
            return (cell * cell) * (pinv @ b.reshape(-1)).reshape(b.shape)
        return _jacobi(torch.zeros_like(b), b, cell, _H_diag(cell), 40, w)
    if n % 2:
        # odd resolution (fractional hCoef): cannot 2x-coarsen; smooth only
        return _jacobi(torch.zeros_like(b), b, cell, _H_diag(cell), 20, w)
    diag = _H_diag(cell)
    u = _jacobi(torch.zeros_like(b), b, cell, diag, nu, w)
    r = b - _Hp_apply(u, cell, w)
    e = v_cycle(restrict(r), 2.0 * cell, nu, coarsest, pins_c)
    u = u + prolong(e)
    return _jacobi(u, b, cell, diag, nu, w)


def build_pin_masks(nodes8: torch.Tensor, shape, dtype: torch.dtype,
                    coarsest: int = 8):
    """Per-level pin masks for the penalized V-cycle, in the compute dtype:
    1 at every node a constraint row touches on the fine grid, restricted
    down the hierarchy (x8, clipped to [0, 1]).  Level 0 first."""
    N = int(np.prod(shape))
    m0 = torch.zeros(N, dtype=dtype, device=nodes8.device)
    m0[nodes8.reshape(-1)] = 1.0
    masks = [m0.reshape(shape)]
    n = shape[0]
    while n > coarsest and n % 2 == 0:
        masks.append(torch.clamp(restrict(masks[-1]) * 8.0, 0.0, 1.0))
        n //= 2
    return tuple(masks)


def make_node_preconditioner(shape, cell: float, pins=None):
    """One V-cycle as a preconditioner on flat (N,) node vectors."""

    def precond(r_flat):
        return v_cycle(r_flat.reshape(shape), cell, pins=pins).reshape(-1)

    return precond
