"""Ring-scheduled Step-1 Yukawa summation over a device mesh (port of
shm3d.parallel.ring).

Structurally the Step-1 sum is unnormalized attention, so the multi-device
decomposition is ring attention: queries (grid nodes) are split over the
mesh and never move; the source shards (points and area-weighted normals)
rotate around the ring, one hop a step, each hop an explicit copy to the
next shard's device.

- A 1-D mesh runs the flat ring over ``"d"``.
- A 2-D mesh runs the hierarchical ring: each outer step is a full inner
  pass over ``"d"`` (the shards come home within the slice), then one
  forward of the slice's shards over ``"s"``.

On every hop a shard runs K1's partial kernel (``yukawa_partials``, the
instantiation of the queries' dtype, float32 or float64, with that
kernel's chunk length) on its resident queries against the source shard
it holds, keeping per source chunk a reference exponent and the sum
relative to it.  At the end one
merge (``yukawa_merge``) combines all hops' partials in the sources'
home-shard order, not in hop order, so the result depends on neither the
mesh's shape nor the hop schedule: a 1-D and a 2-D mesh over the same
shards give one field bit for bit.  The partials of every hop are kept
(stacked, (P x C, Q/P, 4) a shard: 33.5 MB at 128^3 on 4 shards) and merged
once.
"""

from __future__ import annotations

from typing import List

import torch

from ..ops.yukawa import _FAR, yukawa_chunk_len, yukawa_merge, yukawa_partials
from .shards import DeviceMesh, Shards, pad_axis_to_multiple, shard_rows


def _hops(mesh: DeviceMesh):
    """For each step of the schedule, the home shard of the sources each
    device holds (flat, slice-major): the flat ring's i - h, or the
    hierarchical ring's slice (s - o) and position (d - h)."""
    if len(mesh.shape) == 1:
        P = mesh.shape[0]
        return [[(i - h) % P for i in range(P)] for h in range(P)]
    S, D = mesh.shape
    return [[((s - o) % S) * D + (d - h) % D for s in range(S) for d in range(D)]
            for o in range(S) for h in range(D)]


def _rotate(parts: List[torch.Tensor], mesh: DeviceMesh, home_now, home_next):
    """One hop: each device receives the shard it holds next, copied from
    the device that holds it now."""
    where = {home: i for i, home in enumerate(home_now)}
    return [parts[where[home]].to(dev) for home, dev in zip(home_next, mesh.devices)]


def yukawa_field_ring(
    queries,
    src_points: torch.Tensor,
    src_vectors: torch.Tensor,
    lam,
    mesh: DeviceMesh,
    normalize: bool = True,
    q_tile: int = 4096,
) -> Shards:
    """Ring-scheduled Yukawa field over ``mesh``.

    ``queries``: a (Q, 3) tensor, or ``Shards`` of it over ``mesh`` (z-slabs
    of grid nodes stay where they are).  Sources are padded to shard evenly
    with far, zero-weight entries; a (Q, 3) tensor of queries is padded with
    zeros to a multiple of the mesh size, and the padded rows are cut off.
    Returns (Q, 3) as ``Shards`` over the mesh, split like the queries (the
    last shard shorter by the query padding).  ``q_tile``: the plain
    version's query tile (CPU shards)."""
    P = len(mesh)
    if isinstance(queries, Shards):
        q_parts, Q = list(queries.parts), queries.shape[0]
    else:
        queries, Q = pad_axis_to_multiple(queries, P)
        q_parts = shard_rows(queries, mesh).parts
    dtype = q_parts[0].dtype
    sp = shard_rows(pad_axis_to_multiple(src_points.to(dtype), P, value=_FAR)[0], mesh).parts
    sv = shard_rows(pad_axis_to_multiple(src_vectors.to(dtype), P)[0], mesh).parts

    schedule = _hops(mesh)
    partials = [[None] * P for _ in range(P)]  # [device][home shard]
    for step, homes in enumerate(schedule):
        for i, (q, home) in enumerate(zip(q_parts, homes)):
            chunk = (yukawa_chunk_len(q.shape[0], sp[i].shape[0], q.device, dtype)
                     if q.device.type == "cuda" else sp[i].shape[0])
            partials[i][home] = yukawa_partials(q, sp[i], sv[i], lam, chunk, q_tile)
        if step + 1 < len(schedule):
            sp = _rotate(sp, mesh, homes, schedule[step + 1])
            sv = _rotate(sv, mesh, homes, schedule[step + 1])
    out = [yukawa_merge(torch.cat(row), normalize) for row in partials]
    cut = sum(p.shape[0] for p in out) - Q  # the query padding, at the end
    for k in reversed(range(P)):
        drop = min(cut, out[k].shape[0])
        out[k] = out[k][:out[k].shape[0] - drop]
        cut -= drop
    return Shards(out, mesh)
