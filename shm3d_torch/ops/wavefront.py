"""Wavefront variant of the greedy ("fast") grid integration (port of
shm3d.ops.wavefront).

The reference integrates phi along a BFS tree from corner node (0,0,0) with
edge increments from the normalized average of the endpoint vectors; the
host transcription (``oracle.reference.integrate_greedily_grid``) is exact
but a Python loop.  Here each sweep gives every unvisited node next to the
visited region a value through one parent, the first visited 6-neighbor in
the reference's order (x-, x+, y-, y+, z-, z+), with the same increment.
After at most 3(n-1) sweeps every node has a value.

Greedy integration is path-dependent: the BFS queue and the wavefront pick
different spanning trees, so phi differs from the host BFS by the method's
path-integration error.  On a constant field both are exact and equal.
"""

from __future__ import annotations

import torch

# sweeps between two tests of "every node visited" (one host sync each);
# sweeps past completion change nothing, so the result does not depend on it
CHECK_EVERY = 16


def _from_parent(a: torch.Tensor, dim: int, delta: int, fill) -> torch.Tensor:
    """Value at each node's parent (the node shifted by -delta along
    ``dim``); ``fill`` where the parent is outside the grid."""
    n = a.shape[dim]
    pad = torch.full_like(a.narrow(dim, 0, 1), fill)
    if delta > 0:
        return torch.cat([pad, a.narrow(dim, 0, n - 1)], dim=dim)
    return torch.cat([a.narrow(dim, 1, n - 1), pad], dim=dim)


def greedy_integrate_wavefront(Y: torch.Tensor, cell_size: float, shape):
    """(N, 3) normalized field -> ((N,) phi, sweeps run, nodes visited), by
    wavefront sweeps from corner (0,0,0), on the field's device and in its
    dtype."""
    n = shape[0]
    Y3 = Y.reshape(*shape, 3)
    # array dims are (k, j, i) = (z, y, x); axis a's array dim is 2 - a.
    # The six edge increments depend only on Y: computed once.
    dirs = []
    for axis in (0, 1, 2):
        for delta in (-1, 1):
            dim = 2 - axis
            Yavg = _from_parent(Y3, dim, delta, 0.0) + Y3
            Yavg = Yavg / torch.linalg.vector_norm(Yavg, dim=-1, keepdim=True)
            dirs.append((dim, delta, Yavg[..., axis] * (delta * cell_size)))
    phi = torch.zeros(shape, dtype=Y.dtype, device=Y.device)
    visited = torch.zeros(shape, dtype=torch.bool, device=Y.device)
    visited[0, 0, 0] = True
    sweeps, max_sweeps = 0, 3 * (n - 1)
    while sweeps < max_sweeps:
        newphi = phi
        chosen = torch.zeros_like(visited)
        for dim, delta, inc in dirs:
            take = _from_parent(visited, dim, delta, False) & ~visited & ~chosen
            newphi = torch.where(take, _from_parent(phi, dim, delta, 0.0) + inc, newphi)
            chosen = chosen | take
        phi, visited = newphi, visited | chosen
        sweeps += 1
        if sweeps % CHECK_EVERY == 0 and bool(visited.all()):
            break
    return phi.reshape(-1), sweeps, int(visited.sum())
