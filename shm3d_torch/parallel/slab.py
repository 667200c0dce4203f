"""The grid stencils on z-slabs with a one-plane halo (the sharded
counterparts of shm3d_torch.ops.stencil).

Each slab is one shard's (nz, ny, nx) block of an (n, n, n) field.  A slab
takes its neighbours' adjacent planes (``shards.halo_planes``) and then
computes every node with the operations of the single-device stencil in
their order, so the slab result is bitwise equal to it.  The terms that
belong to the domain's first and last plane (the Laplacian's replicated
pad, the divergence's last-row terms) apply on the first and last slab
only: a slab edge is not a domain edge.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F

from ..ops.stencil import _COMPONENT_AXIS
from .shards import halo_planes


def laplacian_apply(parts: Sequence[torch.Tensor], cell_size: float) -> List[torch.Tensor]:
    """``stencil.laplacian_apply`` on (nz, ny, nx) slabs."""
    lo, hi = halo_planes(parts)
    out = []
    for u, below, above in zip(parts, lo, hi):
        # the replicated pad along z only at the domain's ends
        ext = torch.cat([u[:1] if below is None else below, u,
                         u[-1:] if above is None else above])
        up = F.pad(ext[None, None], (1, 1, 1, 1, 0, 0), mode="replicate")[0, 0]
        acc = (
            -6.0 * u
            + up[2:, 1:-1, 1:-1] + up[:-2, 1:-1, 1:-1]
            + up[1:-1, 2:, 1:-1] + up[1:-1, :-2, 1:-1]
            + up[1:-1, 1:-1, 2:] + up[1:-1, 1:-1, :-2]
        )
        out.append(acc / (cell_size * cell_size))
    return out


def divergence_apply(parts: Sequence[torch.Tensor], cell_size: float) -> List[torch.Tensor]:
    """``stencil.divergence_apply`` on (nz, ny, nx, 3) slabs of at least two
    planes.  The z component's (D^T y)_j = y_{j-1} - y_j takes y_{j-1} of a
    slab's first plane from the previous slab; the backward difference's
    last-row terms belong to the last slab."""
    lo, _ = halo_planes([Y[..., 2] for Y in parts])
    last = len(parts) - 1
    out = []
    for k, Y in enumerate(parts):
        acc = torch.zeros(Y.shape[:3], dtype=Y.dtype, device=Y.device)
        for comp in range(3):
            axis = _COMPONENT_AXIS[comp]
            n = Y.shape[axis]
            y = Y[..., comp] / cell_size
            d = -y
            d.narrow(axis, 1, n - 1).add_(y.narrow(axis, 0, n - 1))
            if axis == 0 and lo[k] is not None:
                d[:1].add_(lo[k] / cell_size)
            if axis != 0 or k == last:
                y_last = y.narrow(axis, n - 1, 1)
                d.narrow(axis, n - 2, 1).sub_(y_last)
                d.narrow(axis, n - 1, 1).add_(2.0 * y_last)
            acc += d
        out.append(acc)
    return out
