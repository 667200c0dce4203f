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

On one CUDA device the sweeps run as CUDA graphs (``solve.graphs``), the
counterpart of shm3d's jitted ``_sweep_chunk``: one replay a chunk of
CHECK_EVERY sweeps (a second graph for the last, shorter chunk), the
"every node visited" flag computed inside the graph and read by the host
once a chunk, as the eager loop reads it.  The same sweeps in the same
order: the graphs give the eager loop's phi bit for bit.
"""

from __future__ import annotations

import torch

from ..solve import graphs
from ..utils import timing

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


def sweep(phi: torch.Tensor, visited: torch.Tensor, dirs):
    """One sweep: every unvisited node next to the visited region takes its
    value through its first visited parent in ``dirs`` ((dim, delta,
    increment) in the reference's order); returns the new (phi, visited)."""
    newphi = phi
    chosen = torch.zeros_like(visited)
    for dim, delta, inc in dirs:
        take = _from_parent(visited, dim, delta, False) & ~visited & ~chosen
        newphi = torch.where(take, _from_parent(phi, dim, delta, 0.0) + inc, newphi)
        chosen = chosen | take
    return newphi, visited | chosen


def sweep_loop(phi: torch.Tensor, visited: torch.Tensor, dirs, max_sweeps: int):
    """The eager loop: sweeps until every node is visited (tested every
    CHECK_EVERY sweeps) or ``max_sweeps``; returns (phi, visited, sweeps)."""
    sweeps = 0
    while sweeps < max_sweeps:
        phi, visited = sweep(phi, visited, dirs)
        sweeps += 1
        if sweeps % CHECK_EVERY == 0 and bool(visited.all()):
            break
    return phi, visited, sweeps


def chunk_body(s: dict, dirs, count: int) -> None:
    """``count`` sweeps on the state ``s`` (phi, visited, done) in place,
    the increments read from ``s["inc0"]``... (``dirs``: (dim, delta)
    pairs), then ``copy_`` into the state with the "every node visited"
    flag."""
    incs = [(dim, delta, s[f"inc{i}"]) for i, (dim, delta) in enumerate(dirs)]
    phi, visited = s["phi"], s["visited"]
    for _ in range(count):
        phi, visited = sweep(phi, visited, incs)
    done = visited.all()
    s["phi"].copy_(phi)
    s["visited"].copy_(visited)
    s["done"].copy_(done)


def greedy_integrate_wavefront(Y: torch.Tensor, cell_size: float, shape, cache=None):
    """(N, 3) normalized field -> ((N,) phi, sweeps run, nodes visited), by
    wavefront sweeps from corner (0,0,0), on the field's device and in its
    dtype.  ``cache``: a dict for the chunk graphs (``graphs.wavefront_runner``;
    the solver's cache entry for the geometry), or None for the eager loop."""
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
    max_sweeps = 3 * (n - 1)
    run = graphs.wavefront_runner(cache, ("wavefront", tuple(shape), Y.dtype), Y)
    if run is None:
        phi, visited, sweeps = sweep_loop(phi, visited, dirs, max_sweeps)
        return phi.reshape(-1), sweeps, int(visited.sum())
    # one graph a chunk length: CHECK_EVERY sweeps, and the last chunk's
    chunks = [min(CHECK_EVERY, max_sweeps - d) for d in range(0, max_sweeps, CHECK_EVERY)]
    sizes = sorted(set(chunks), reverse=True)
    init = dict(phi=phi, visited=visited, done=visited.new_zeros(()),
                **{f"inc{i}": inc for i, (_, _, inc) in enumerate(dirs)})
    pairs = [(dim, delta) for dim, delta, _ in dirs]
    stepper = run(init, lambda s: [lambda c=c: chunk_body(s, pairs, c) for c in sizes])
    sweeps = 0
    for count in chunks:
        stepper.step(sizes.index(count))
        sweeps += count
        if count == CHECK_EVERY:
            with timing.tally("done flag read", timing.WAIT):
                done = bool(stepper.state["done"])
            if done:
                break
    return (stepper.state["phi"].reshape(-1).clone(), sweeps,
            int(stepper.state["visited"].sum()))
