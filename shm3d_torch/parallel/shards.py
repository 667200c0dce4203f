"""Device meshes and z-slab shards for the grid pipeline (port of
shm3d.parallel.shards).

``shm3d``'s mesh has one controller: one process drives every device of a
``jax.sharding.Mesh``, and XLA inserts the collectives.  The port keeps that
contract without ``torch.distributed``: a ``DeviceMesh`` is a grid of
``torch.device``s in one process (a device may repeat, the counterpart of
XLA's virtual CPU devices), a sharded array is a ``Shards`` of per-device
tensors, and every collective is an explicit copy between them.  The same
code runs CPU shards in the tests, repeated shards of one card, and
``cuda:0..k-1`` on a node with k cards.

Layout (as in ``shm3d``): grid node fields are split along z, the leading
axis of the (nz, ny, nx) layout, so a flat (N,) node vector in the
reference node order splits into contiguous z-slabs; over a 2-D mesh the
blocks go slice-major.  Sources split the same way, by rows.

The collectives: ``halo_planes`` (one plane from each neighbouring slab),
``Shards.gather`` (rows back onto one device), ``broadcast`` (a replicated
tensor on every shard's device) and ``fixed_sum`` (per-shard scalars summed
in shard order, so no reduction depends on timing).  No atomics anywhere.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """Devices as an (n,) grid with axis ``"d"`` or an (n_slices, n/n_slices)
    grid with axes ``("s", "d")``; ``devices`` is the grid flattened
    slice-major, the order of the shards."""

    devices: Tuple[torch.device, ...]
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    def __len__(self) -> int:
        return len(self.devices)

    @property
    def first(self) -> torch.device:
        return self.devices[0]

    def describe(self) -> dict:
        return dict(axis_names=list(self.axis_names), shape=list(self.shape),
                    devices=[str(d) for d in self.devices])


def device_mesh(n_devices: Optional[int] = None, devices: Optional[Sequence] = None,
                n_slices: int = 1, device="cuda") -> DeviceMesh:
    """Device mesh over ``devices`` (which may repeat one device) or over the
    first ``n_devices`` devices of ``device``'s type: for ``"cuda"`` the
    visible cards (default: all of them; asking for more raises), for
    ``"cpu"`` that many CPU shards (default 1).

    ``n_slices == 1``: 1-D mesh, axis ``"d"``.  ``n_slices > 1``: 2-D mesh,
    axes ``("s", "d")``, each row one slice (the ring rotates sources over
    ``"d"`` and forwards once over ``"s"`` a pass)."""
    if devices is None:
        kind = torch.device(device).type
        if kind == "cuda":
            have = torch.cuda.device_count()
            n = have if n_devices is None else int(n_devices)
            if n < 1 or n > have:
                raise RuntimeError(f"device_mesh: {n} CUDA devices asked for, "
                                   f"{have} visible")
            devices = [torch.device("cuda", i) for i in range(n)]
        elif kind == "cpu":
            devices = ["cpu"] * (1 if n_devices is None else int(n_devices))
        else:
            raise ValueError(f"unsupported device {device!r}; expected cuda or cpu")
    devs = tuple(torch.device(d) for d in devices)
    for d in devs:
        if d.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {d} in the mesh but torch.cuda.is_available() is False")
    if not devs:
        raise ValueError("device_mesh: no devices")
    if n_slices <= 1:
        return DeviceMesh(devs, (len(devs),), ("d",))
    if len(devs) % n_slices:
        raise ValueError(f"{len(devs)} devices not divisible into {n_slices} slices")
    return DeviceMesh(devs, (n_slices, len(devs) // n_slices), ("s", "d"))


def _on(x, device: torch.device):
    """A scalar operand on ``device`` (Python numbers pass through)."""
    return x.to(device) if isinstance(x, torch.Tensor) else x


class Shards:
    """One array's rows in contiguous blocks, block k on ``mesh.devices[k]``
    (a flat node vector: its z-slabs).  Arithmetic is block by block, with
    a scalar tensor operand copied to each block's device, so every entry
    takes the same operations as in the unsharded array."""

    __slots__ = ("parts", "mesh")

    def __init__(self, parts: List[torch.Tensor], mesh: DeviceMesh):
        self.parts = list(parts)
        self.mesh = mesh

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0].dtype

    @property
    def device(self) -> torch.device:
        return self.parts[0].device

    @property
    def shape(self) -> Tuple[int, ...]:
        return (sum(p.shape[0] for p in self.parts),) + tuple(self.parts[0].shape[1:])

    def _map(self, fn, other=None) -> "Shards":
        if isinstance(other, Shards):
            return Shards([fn(a, b) for a, b in zip(self.parts, other.parts)], self.mesh)
        return Shards([fn(a, _on(other, a.device)) for a in self.parts], self.mesh)

    def __add__(self, o):
        return self._map(lambda a, b: a + b, o)

    def __sub__(self, o):
        return self._map(lambda a, b: a - b, o)

    def __mul__(self, o):
        return self._map(lambda a, b: a * b, o)

    def __rmul__(self, o):
        return self._map(lambda a, b: b * a, o)

    def __truediv__(self, o):
        return self._map(lambda a, b: a / b, o)

    def __neg__(self):
        return Shards([-a for a in self.parts], self.mesh)

    def to(self, dtype: torch.dtype) -> "Shards":
        return Shards([a.to(dtype) for a in self.parts], self.mesh)

    def abs(self) -> "Shards":
        return Shards([a.abs() for a in self.parts], self.mesh)

    def max(self) -> torch.Tensor:
        """The largest entry, on the first device (exact in any order)."""
        first = self.parts[0].device
        return torch.stack([a.max().to(first) for a in self.parts]).max()

    def zeros_like(self) -> "Shards":
        return Shards([torch.zeros_like(a) for a in self.parts], self.mesh)

    def dot(self, other: "Shards") -> torch.Tensor:
        """sum(self * other): per-shard dots summed in shard order."""
        return fixed_sum([torch.dot(a, b) for a, b in zip(self.parts, other.parts)])

    def norm(self) -> torch.Tensor:
        return torch.sqrt(self.dot(self))

    def gather(self, device=None) -> torch.Tensor:
        """The whole array on ``device`` (default: the mesh's first)."""
        dev = self.mesh.first if device is None else torch.device(device)
        return torch.cat([a.to(dev) for a in self.parts])


def shard_rows(x: torch.Tensor, mesh: DeviceMesh) -> Shards:
    """Split ``x`` along dim 0 into ``len(mesh)`` equal contiguous blocks on
    the mesh's devices (slice-major).  The row count must divide evenly
    (``pad_axis_to_multiple``)."""
    P = len(mesh)
    if x.shape[0] % P:
        raise ValueError(f"{x.shape[0]} rows do not split over {P} shards")
    return Shards([blk.to(d) for blk, d in zip(torch.chunk(x, P), mesh.devices)], mesh)


# shm3d's shardings of node vectors, (nz, ny, nx) fields, (nz, ny, nx, 3)
# fields and (S, ...) sources all split dim 0 over every mesh axis
node_sharding = field3_sharding = field3v_sharding = source_sharding = shard_rows


def broadcast(x: torch.Tensor, mesh: DeviceMesh) -> List[torch.Tensor]:
    """A replicated tensor: one copy on each shard's device (a device that
    repeats shares one copy)."""
    return [x.to(d) for d in mesh.devices]


replicated = broadcast


def fixed_sum(values: Sequence[torch.Tensor]) -> torch.Tensor:
    """sum(values) in list order on the first value's device."""
    dev = values[0].device
    total = values[0]
    for v in values[1:]:
        total = total + v.to(dev)
    return total


def halo_planes(parts: Sequence[torch.Tensor]):
    """(lo, hi): for each slab (nz, ...) the previous slab's last plane and
    the next slab's first plane, each copied onto this slab's device, and
    None at the domain's first and last plane."""
    P = len(parts)
    lo = [None] + [parts[k - 1][-1:].to(parts[k].device) for k in range(1, P)]
    hi = [parts[k + 1][:1].to(parts[k].device) for k in range(P - 1)] + [None]
    return lo, hi


def pad_axis_to_multiple(x: torch.Tensor, multiple: int, axis: int = 0, value=0.0):
    """Pad ``axis`` up to a multiple (shard evenness); returns (padded,
    original size)."""
    size = x.shape[axis]
    target = -(-size // multiple) * multiple
    if target == size:
        return x, size
    pad_shape = list(x.shape)
    pad_shape[axis] = target - size
    fill = torch.full(pad_shape, value, dtype=x.dtype, device=x.device)
    return torch.cat([x, fill], dim=axis), size
