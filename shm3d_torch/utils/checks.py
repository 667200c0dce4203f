"""Numerical sanitizer: runtime checks of solver invariants (port of
shm3d.utils.checks on torch tensors).

What corrupts a solver silently is numerics: NaN or Inf escaping a guard, a
hand-written adjoint that drifted from its forward operator, a "projected"
iterate leaving the constraint null space.  These checks run at phase
boundaries, off by default, on with ``SHM3D_DEBUG=1`` or the CLI's
``--debug``.  Each pulls a few scalars from the device, not whole arrays,
and raises ``NumericalCheckError`` naming the phase, so a corrupted solve
fails at the first bad phase instead of returning garbage phi.
"""

from __future__ import annotations

import os
from typing import Callable

import numpy as np
import torch

from ..parallel.shards import Shards

ENABLED: bool = bool(os.environ.get("SHM3D_DEBUG", ""))


class NumericalCheckError(AssertionError):
    pass


def enabled() -> bool:
    return ENABLED


def enable(flag: bool = True) -> None:
    global ENABLED
    ENABLED = flag


def _tensor(a) -> torch.Tensor:
    if isinstance(a, Shards):
        return a.gather()
    return a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))


def check_finite(name: str, arr, allow_fraction: float = 0.0) -> None:
    """All entries finite, up to ``allow_fraction`` of them (Step 1 gives
    NaN directions at grid nodes on a source, which the divergence guard
    zeroes afterwards)."""
    if not ENABLED:
        return
    bad = float((~torch.isfinite(_tensor(arr))).float().mean())
    if bad > allow_fraction:
        raise NumericalCheckError(
            f"{name}: {bad:.2%} non-finite entries (allowed {allow_fraction:.2%})"
        )


def check_adjoint(name: str, fwd: Callable, adj: Callable, shape_in, shape_out,
                  dtype=torch.float64, rtol: float = 1e-4, seed: int = 0) -> None:
    """Randomized adjointness <fwd(x), y> == <x, adj(y)> on host tensors.
    One random probe fails a systematic mismatch with probability 1."""
    if not ENABLED:
        return
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.standard_normal(shape_in), dtype=dtype)
    y = torch.as_tensor(rng.standard_normal(shape_out), dtype=dtype)
    lhs = float(torch.dot(_tensor(fwd(x)).reshape(-1).to(dtype).cpu(), y.reshape(-1)))
    rhs = float(torch.dot(x.reshape(-1), _tensor(adj(y)).reshape(-1).to(dtype).cpu()))
    scale = max(abs(lhs), abs(rhs), np.finfo(np.float64).tiny)
    if abs(lhs - rhs) / scale > rtol:
        raise NumericalCheckError(
            f"{name}: adjoint mismatch <Ax,y>={lhs:.6e} vs <x,A*y>={rhs:.6e}"
        )


def check_symmetric(name: str, matvec: Callable, n: int, dtype=torch.float64,
                    rtol: float = 1e-4, seed: int = 0) -> None:
    """Randomized symmetry <Ax, y> == <x, Ay> of an implicit operator: CG
    assumes it, and an asymmetric assembly makes CG silently wrong."""
    if not ENABLED:
        return
    check_adjoint(name, matvec, matvec, (n,), (n,), dtype, rtol, seed)


def check_constraint(name: str, u, a_apply: Callable, b_scale: float,
                     rtol: float = 1e-3) -> None:
    """A u ~ 0 relative to the right-hand side's scale: the null-space
    method's invariant (shm3d_torch.solve.projection)."""
    if not ENABLED:
        return
    viol = float(torch.linalg.vector_norm(_tensor(a_apply(u))))
    if not np.isfinite(viol) or viol > rtol * max(b_scale, np.finfo(np.float64).tiny):
        raise NumericalCheckError(
            f"{name}: constraint violation |Au|={viol:.3e} "
            f"(rhs scale {b_scale:.3e}, rtol {rtol})"
        )


def check_unit_field(name: str, Y, rtol: float = 1e-2,
                     allow_fraction: float = 1e-3) -> None:
    """Step-2 rows are unit vectors; NaN rows (a node on a source) are
    exempt up to ``allow_fraction``."""
    if not ENABLED:
        return
    norms = torch.linalg.vector_norm(_tensor(Y), dim=-1)
    finite = torch.isfinite(norms)
    bad_nan = float((~finite).float().mean())
    worst = float(torch.where(finite, (norms - 1.0).abs(), torch.zeros_like(norms)).max())
    if bad_nan > allow_fraction or worst > rtol:
        raise NumericalCheckError(
            f"{name}: non-unit field (max |‖Y‖-1| = {worst:.3e}, "
            f"{bad_nan:.2%} non-finite rows)"
        )
