"""Grid stencil operators on (nz, ny, nx) tensors (port of shm3d.ops.stencil).

Conventions follow shm3d.domains.grid: a flat node vector with index
i + j*n + k*n^2 reshapes to a C-order (nz, ny, nx) tensor u[k, j, i]; the
vector components (x, y, z) live on axes (2, 1, 0).

The 7-point Laplacian uses mirrored boundary differences (edge-replicated
padding).  The gradient is a forward difference whose last entry falls back
to the backward difference.  The divergence is its exact adjoint D^T,
written out term by term (the JAX package derives it with
``jax.linear_transpose``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# axis of the 3-D layout for the (x, y, z) components
_COMPONENT_AXIS = {0: 2, 1: 1, 2: 0}


def laplacian_apply(u: torch.Tensor, cell_size: float) -> torch.Tensor:
    """L u for the mirrored 7-point Laplacian (negative semi-definite),
    scaled 1/cell_size^2: one edge-replicated pad plus six slice-adds."""
    up = F.pad(u[None, None], (1, 1, 1, 1, 1, 1), mode="replicate")[0, 0]
    acc = (
        -6.0 * u
        + up[2:, 1:-1, 1:-1] + up[:-2, 1:-1, 1:-1]
        + up[1:-1, 2:, 1:-1] + up[1:-1, :-2, 1:-1]
        + up[1:-1, 1:-1, 2:] + up[1:-1, 1:-1, :-2]
    )
    return acc / (cell_size * cell_size)


def gradient_apply(u: torch.Tensor, cell_size: float) -> torch.Tensor:
    """Forward-difference gradient -> (nz, ny, nx, 3), components (x, y, z);
    the last entry along each axis is the backward difference."""
    comps = []
    for comp in range(3):
        axis = _COMPONENT_AXIS[comp]
        n = u.shape[axis]
        head = u.narrow(axis, 1, n - 1) - u.narrow(axis, 0, n - 1)
        last = u.narrow(axis, n - 1, 1) - u.narrow(axis, n - 2, 1)
        comps.append(torch.cat([head, last], dim=axis))
    return torch.stack(comps, dim=-1) / cell_size


def divergence_apply(Y: torch.Tensor, cell_size: float) -> torch.Tensor:
    """D^T Y for Y of shape (nz, ny, nx, 3): the exact adjoint of
    ``gradient_apply``.  Along each axis, with y = Y[..., c] / cell_size:
    (D^T y)_j = y_{j-1} - y_j (y_{-1} = 0), except that the backward
    difference in the last row adds -y_{n-1} at n-2 and +2 y_{n-1} at n-1
    (the same terms as shm3d.ops.stencil._adjoint_terms)."""
    out = torch.zeros(Y.shape[:3], dtype=Y.dtype, device=Y.device)
    for comp in range(3):
        axis = _COMPONENT_AXIS[comp]
        n = Y.shape[axis]
        y = Y[..., comp] / cell_size
        d = -y
        d.narrow(axis, 1, n - 1).add_(y.narrow(axis, 0, n - 1))
        y_last = y.narrow(axis, n - 1, 1)
        d.narrow(axis, n - 2, 1).sub_(y_last)
        d.narrow(axis, n - 1, 1).add_(2.0 * y_last)
        out += d
    return out
