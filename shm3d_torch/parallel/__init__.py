"""Multi-device solves in one process (port of shm3d.parallel): the device
mesh and its z-slab shards, the ring-scheduled Step 1, the slab stencils of
the grid domain, and the row-sharded operators of the tet domain."""

from .ring import yukawa_field_ring
from .rows import RowSharded
from .shards import (
    DeviceMesh,
    Shards,
    device_mesh,
    field3_sharding,
    field3v_sharding,
    node_sharding,
    pad_axis_to_multiple,
    replicated,
    source_sharding,
)

__all__ = [
    "yukawa_field_ring",
    "device_mesh",
    "node_sharding",
    "field3_sharding",
    "field3v_sharding",
    "source_sharding",
    "replicated",
    "pad_axis_to_multiple",
    "DeviceMesh",
    "RowSharded",
    "Shards",
]
