"""Row-sharded sparse operators on a device mesh: the tet domain's Step 3 on
several devices (port of the row placement in shm3d.solve.ell.device_put_tree).

``shm3d`` places the rows of every Step-3 operator on the mesh and lets
GSPMD run each product as a distributed SpMV: x gathered once a product,
each device its row block.  The port writes that schedule out on the
single-process mesh of ``shards.py`` for every operator in the sliced-ELL
kernel's encoding (``pell.SellMat``: the face operator L and the vertex
operator S H S in float32, and the AMG levels stored paged):

- its rows are split at 32-row slice boundaries into one block a shard,
  balanced by slots; a block is a sub-range of ``vals``/``cols`` with its
  ``slice_ptr`` rebased, uploaded to its shard's device;
- a product copies x to every shard's device (``broadcast``), launches the
  kernel on each block there and concatenates the blocks' outputs, in block
  order, on the mesh's first device, where the solves' vectors stay whole
  (the Krylov arithmetic, dots, projectors and divergences run there as on
  one device).

The kernel sums each row's slots in order in one thread, so a block gives
its rows' sums bit for bit and a split product equals one launch.  The plain
encodings (``ell.EllMat``, ``ell.SlicedEll``: the AMG transfers and smaller
levels, the projection Gram, every operator in float64) stay whole on the
first device: they sum a panel's slots with torch's reduction, whose order
on CUDA follows the panel's shape (its vector width follows the row count's
divisibility), so a split panel would not give the unsplit panel's sums
(``scripts/split_panel_sums.py`` counts the split float32 panels that sum
otherwise on the card).  An operator with fewer than 32 rows a shard is
not split either (the counterpart of ``shm3d``'s "shard iff >= 2 rows a
device").  Nothing here uses an atomic: the concatenation is a copy.

Unlike ``shm3d``, which pads the host panels to the mesh size and keys its
artifact by it, the split is made at upload: one host artifact serves one
device and every mesh.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..solve import ell
from .shards import DeviceMesh, broadcast

#: rows of a sliced-ELL slice: the granularity of the split
SLICE = 32

# Block products (one per block a product) and copies of x to the shards'
# devices (one per product) in this process, incremented by ``matvec`` only.
ROW_BLOCK_LAUNCHES = 0
BROADCASTS = 0


@dataclasses.dataclass(frozen=True)
class RowSharded:
    """A sliced-ELL operator's rows in contiguous blocks: ``blocks[k]`` is
    the ``SellMat`` of rows [row_starts[k], row_starts[k + 1]) on
    ``mesh.devices[k]``."""

    blocks: Tuple
    row_starts: Tuple[int, ...]
    mesh: DeviceMesh

    @property
    def n_rows(self) -> int:
        return self.row_starts[-1]

    @property
    def block_rows(self) -> List[int]:
        """Rows of each block."""
        return [b - a for a, b in zip(self.row_starts[:-1], self.row_starts[1:])]


def splits(op) -> bool:
    """Whether ``op`` (a host operator in its device encoding) is one that
    a mesh splits by rows: the sliced-ELL kernel's encoding."""
    from ..solve import pell

    return isinstance(op, pell.SellMat)


def _cuts(ptr: np.ndarray, n_rows: int, P: int) -> Optional[List[int]]:
    """Slice boundaries of P blocks, balanced by slots, at least one slice a
    block; None when n_rows < SLICE * P."""
    if n_rows < SLICE * P:
        return None
    n_slices = ptr.shape[0] - 1
    targets = ptr[-1] * np.arange(1, P) / P
    b = [0]
    for k, c in enumerate(np.searchsorted(ptr, targets, side="left"), 1):
        b.append(int(min(max(int(c), b[-1] + 1), n_slices - (P - k))))
    return b + [n_slices]


def split(op, mesh: DeviceMesh) -> Optional[RowSharded]:
    """The row blocks of a host ``SellMat`` (numpy leaves), each on its
    shard's device; None when it has fewer than 32 rows a shard."""
    from ..solve import pell

    ptr = np.asarray(op.slice_ptr, np.int64)
    cuts = _cuts(ptr, op.n_rows, len(mesh))
    if cuts is None:
        return None
    blocks, starts = [], []
    for k, dev in enumerate(mesh.devices):
        s0, s1 = cuts[k], cuts[k + 1]
        p0, p1 = int(ptr[s0]), int(ptr[s1])
        vals = np.asarray(op.vals)[p0:p1]
        r0, r1 = SLICE * s0, min(SLICE * s1, op.n_rows)
        blocks.append(pell.SellMat(
            ell.to_tensor(vals, dev), ell.to_tensor(np.asarray(op.cols)[p0:p1], dev),
            ell.to_tensor(ptr[s0:s1 + 1] - p0, dev), r1 - r0, op.n_cols,
            int(np.count_nonzero(vals))))
        starts.append(r0)
    return RowSharded(tuple(blocks), tuple(starts + [op.n_rows]), mesh)


def matvec(op: RowSharded, x: torch.Tensor, n_out: Optional[int] = None) -> torch.Tensor:
    """y = op @ x on the mesh's first device: x copied to every shard's
    device, the kernel launched on each block there (its plain version on
    CPU shards), the outputs concatenated in block order.  ``n_out``: rows
    to return (default all)."""
    global ROW_BLOCK_LAUNCHES, BROADCASTS
    from ..solve import pell

    n = op.n_rows if n_out is None else int(n_out)
    if not 0 <= n <= op.n_rows:
        raise ValueError(f"n_out={n} outside [0, {op.n_rows}]")
    first = op.mesh.first
    xs = broadcast(x, op.mesh)
    BROADCASTS += 1
    y = torch.cat([pell.sell_matvec(b, xk).to(first) for b, xk in zip(op.blocks, xs)])
    ROW_BLOCK_LAUNCHES += len(op.blocks)
    return y if n == op.n_rows else y[:n]


def block_rows(op) -> Optional[List[int]]:
    """Rows of each block of a RowSharded operator, None for one kept whole."""
    return op.block_rows if isinstance(op, RowSharded) else None


def first_whole_level(levels, op0) -> int:
    """Index of the first AMG level whose operator is applied whole (the
    number of levels when every level's is split); a level without its own
    operator applies the solve's, ``op0``.  The transfers are in the plain
    encodings and stay whole."""
    for i, lvl in enumerate(levels):
        if not isinstance(op0 if lvl.A is None else lvl.A, RowSharded):
            return i
    return len(levels)
