"""Paged-ELL operators (port of shm3d.solve.pell) and the sliced-ELL SpMV
that applies them on the card.

``PagedMat`` is the JAX package's pass decomposition, kept as the host and
disk form: matrix entries are sorted into (output tile, source page)
passes, an output tile being 1024 consecutive rows and a source page 1024
consecutive entries of x.  A pass holds, for one tile, at most one entry
per row from one page (rows with several entries in a page take several
passes); slot ``row % 1024`` of a pass holds the value and the in-page
column.  Passes are sorted by tile and cut into segments of at most
``_SEG_TILES`` tiles and ``_SEG_PASSES`` passes; a pass's meta word is
``local_tile << 20 | page`` with the tile counted from its segment's
``t0``.  ``CRPath.prepare`` and the AMG setup build it, and trees built by
the JAX package, padding included, are read as they are
(``CRPath.from_prepared``).

What the port leaves behind: the compile-shape buckets of the TPU build
(``_bucket``, which padded every segment's pass and tile counts up a
geometric grid so compiled kernels could be reused, and ``cols_pad``, the
power-of-two length x was padded to).  The port's ``build_paged`` stores
the real passes only.

On a device the operator is a ``SellMat``: sliced ELL with 32 rows a slice
(one warp) and no row sorting (the Morton face order already gives
locality).  The paged layout answers a TPU problem, slow random gathers;
on the card it would stream every slot of every pass, ~6x the bytes the
product needs at the CR operators' ~16% slot occupancy.
``ell.device_put_tree`` converts each ``PagedMat`` with :func:`to_sell`.

- ``paged_matvec_torch``: the plain PyTorch version of the pass semantics
  (``_seg_matvec_xla`` and the segment concatenation of ``matvec``); the
  tests' reference for the JAX format, on no solve path.
- ``sell_matvec_torch``: the plain version of the sliced-ELL product.
- ``sell_matvec_cuda``: wrapper of the hand-written Hopper kernel
  (``shm3d_torch/csrc/pell.cu``, the port of the TPU kernel
  ``_pipe_kernel``); float32 CUDA tensors only.
- ``sell_matvec`` / ``apply``: dispatch on the tensor's device (CPU tensors
  take the plain version, CUDA tensors launch the kernel or raise) and, for
  ``apply``, on the operator type.
"""

from __future__ import annotations

import ctypes
import dataclasses
import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from ..parallel import rows
from ..utils import tree as tree_mod
from . import ell, graphs

PAGE = 1024                 # entries per x page / rows per output tile
_SEG_TILES = 2048           # local_tile must fit in 11 bits (i32 sign-safe)
_SEG_PASSES = 150_000       # passes per segment
_PAGE_BITS = 20             # page must fit below the local_tile field

SELL_C = 32                 # rows per slice of a SellMat (one warp)

# Launches of the CUDA kernel in this process (incremented by
# ``sell_matvec_cuda`` only, once per launch: one per matvec; a call while
# a CUDA graph is captured counts at each of the graph's replays instead,
# ``_count_launch``).
KERNEL_LAUNCHES = 0


@tree_mod.register
@dataclasses.dataclass(frozen=True)
class PagedSeg:
    """One segment of passes, covering output tiles [t0, t0 + n_tiles)."""

    vals: np.ndarray   # (T, 1024) compute dtype, slot = row % 1024
    idx: np.ndarray    # (T, 1024) int32, col % 1024
    meta: np.ndarray   # (T,) int32, (local_tile << 20) | page
    t0: int
    n_tiles: int
    # (span + 1,) int64: passes [tile_ptr[j], tile_ptr[j+1]) belong to local
    # tile j of the segment's REAL span (to the next segment's t0); filled
    # by PagedMat, since the span depends on the next segment
    tile_ptr: Optional[np.ndarray] = None


@tree_mod.register
@dataclasses.dataclass(frozen=True)
class PagedMat:
    segs: Tuple[PagedSeg, ...]
    n_rows: int
    n_cols: int
    nnz: int

    def __post_init__(self):
        segs = tuple(self.segs)
        if any(s.tile_ptr is None for s in segs):
            t0s = [s.t0 for s in segs] + [self.n_tiles]
            segs = tuple(
                s if s.tile_ptr is not None else dataclasses.replace(
                    s, tile_ptr=_tile_ptr(s.meta, min(s.n_tiles, t0s[k + 1] - s.t0)))
                for k, s in enumerate(segs))
        object.__setattr__(self, "segs", segs)

    @property
    def n_tiles(self) -> int:
        """Output tiles holding real rows."""
        return max(1, -(-self.n_rows // PAGE))

    @property
    def n_passes(self) -> int:
        return sum(int(s.meta.shape[0]) for s in self.segs)


@tree_mod.register
@dataclasses.dataclass(frozen=True)
class SellMat:
    """Sliced ELL, ``SELL_C`` = 32 rows a slice, rows in their own order.

    Slice s holds rows [32 s, 32 s + 32) in a (w_s, 32) panel, w_s the
    longest row of the slice: slot j of the slice's row l sits at
    ``slice_ptr[s] + 32 j + l``, so a warp's 32 threads read 32 consecutive
    slots.  Each row keeps its entries in ascending column order; padding
    slots have value 0 and repeat the row's last column (0 for an empty
    row).  A slice whose rows are all empty has no slots."""

    vals: np.ndarray        # (n_slots,) compute dtype
    cols: np.ndarray        # (n_slots,) int32
    slice_ptr: np.ndarray   # (n_slices + 1,) int64 slot offsets, multiples of 32
    n_rows: int
    n_cols: int
    nnz: int

    @property
    def n_slices(self) -> int:
        return int(self.slice_ptr.shape[0]) - 1

    @property
    def n_slots(self) -> int:
        return int(self.vals.shape[0])


def _tile_ptr(meta, span: int) -> np.ndarray:
    """Pass offsets of local tiles 0..span of a segment (its passes are
    sorted by tile; padding passes past the real span are left out)."""
    tiles = np.asarray(meta).astype(np.int64) >> _PAGE_BITS
    return np.searchsorted(tiles, np.arange(span + 1), side="left").astype(np.int64)


def build_paged(M, dtype=np.float32) -> PagedMat:
    """Host-side pass decomposition of any scipy sparse matrix.

    The caller is responsible for ordering: pass counts (and hence matvec
    cost) track how well consecutive rows read consecutive columns -- apply
    a locality permutation (Morton on element positions) to the matrix
    first."""
    A = M.tocsr()
    A.sum_duplicates()
    A.sort_indices()
    n, m = A.shape
    if m > (1 << (_PAGE_BITS + 10)):
        raise ValueError(f"paged matvec supports up to 2^30 columns, got {m}")
    counts = np.diff(A.indptr)
    nnz = int(A.indices.size)
    if nnz >= (1 << 31):
        raise ValueError(f"paged matvec supports < 2^31 nonzeros, got {nnz}")
    n_tiles = max(1, -(-n // PAGE))
    n_pages = max(1, -(-m // PAGE))
    if nnz == 0:
        segs = tuple(_empty_seg(t0, min(_SEG_TILES, n_tiles - t0), dtype)
                     for t0 in range(0, n_tiles, _SEG_TILES))
        return PagedMat(segs, n, m, 0)

    rows = np.repeat(np.arange(n, dtype=np.int64), counts)
    cols = A.indices.astype(np.int64)
    page = cols >> 10
    # multiplicity within each (row, page) group: CSR order makes the
    # groups contiguous, so group-start repeats suffice
    grp = rows * n_pages + page
    new = np.ones(nnz, bool)
    new[1:] = grp[1:] != grp[:-1]
    starts_g = np.flatnonzero(new)
    sizes_g = np.diff(np.append(starts_g, nnz))
    mult = np.arange(nnz, dtype=np.int64) - np.repeat(starts_g, sizes_g)
    # pass identity (tile, page, mult), sorted; tile runs stay contiguous
    tile = rows >> 10
    key = (tile * n_pages + page) * PAGE + mult
    order = np.argsort(key, kind="stable")
    ks = key[order]
    new2 = np.ones(nnz, bool)
    new2[1:] = ks[1:] != ks[:-1]
    pass_id = np.cumsum(new2, dtype=np.int32) - 1
    T = int(pass_id[-1]) + 1

    vals3 = np.zeros((T, PAGE), dtype)
    idx3 = np.zeros((T, PAGE), np.int32)
    e = (rows[order] & 1023).astype(np.int32)
    vals3[pass_id, e] = A.data[order].astype(dtype)
    idx3[pass_id, e] = (cols[order] & 1023).astype(np.int32)
    starts_p = np.flatnonzero(new2)    # first sorted entry of each pass
    pass_tile = tile[order[starts_p]]
    pass_page = page[order[starts_p]]

    # tiles with no entries (rectangular shapes) get one zero pass each, so
    # every tile of the pass stream appears in it
    present = np.zeros(n_tiles, bool)
    present[pass_tile] = True
    missing = np.flatnonzero(~present)
    if missing.size:
        vals3 = np.concatenate([vals3, np.zeros((missing.size, PAGE), dtype)])
        idx3 = np.concatenate([idx3, np.zeros((missing.size, PAGE), np.int32)])
        pass_tile = np.concatenate([pass_tile, missing])
        pass_page = np.concatenate([pass_page, np.zeros(missing.size, np.int64)])
        order2 = np.argsort(pass_tile, kind="stable")
        vals3, idx3 = vals3[order2], idx3[order2]
        pass_tile, pass_page = pass_tile[order2], pass_page[order2]
        T += missing.size

    # segment at tile-run boundaries: <= _SEG_TILES tiles AND <= _SEG_PASSES
    # passes per segment
    run_start = np.ones(T, bool)
    run_start[1:] = pass_tile[1:] != pass_tile[:-1]
    starts = np.flatnonzero(run_start)          # first pass of each tile
    start_tiles = pass_tile[starts]
    segs = []
    s_pass = 0
    s_tile_i = 0  # index into starts
    while s_pass < T:
        t0 = int(start_tiles[s_tile_i])
        j = s_tile_i
        while (j + 1 < starts.size
               and int(start_tiles[j + 1]) - t0 < _SEG_TILES
               and int(starts[j + 1]) - s_pass < _SEG_PASSES):
            j += 1
        e_pass = int(starts[j + 1]) if j + 1 < starts.size else T
        t_end = int(start_tiles[j]) + 1
        segs.append(_make_seg(vals3[s_pass:e_pass], idx3[s_pass:e_pass],
                              pass_tile[s_pass:e_pass] - t0,
                              pass_page[s_pass:e_pass], t0, t_end - t0))
        s_pass = e_pass
        s_tile_i = j + 1
    # segments tile [0, n_tiles) contiguously and without overlap
    t0s = [s.t0 for s in segs] + [n_tiles]
    for k, s in enumerate(segs):
        if t0s[k + 1] - s.t0 != s.n_tiles:
            raise AssertionError(
                f"segment {k} covers [{s.t0}, {s.t0}+{s.n_tiles}) but the "
                f"next starts at {t0s[k + 1]}: non-contiguous pass decomposition")
    return PagedMat(tuple(segs), n, m, nnz)


def _make_seg(vals3, idx3, local_tile, page, t0: int, n_tiles: int) -> PagedSeg:
    """Assemble one segment of real passes (no compile-shape padding)."""
    meta = (local_tile.astype(np.int64) << _PAGE_BITS | page).astype(np.int32)
    return PagedSeg(np.ascontiguousarray(vals3), np.ascontiguousarray(idx3),
                    meta, t0, n_tiles)


def _empty_seg(t0: int, n_tiles: int, dtype) -> PagedSeg:
    # one zeroing pass per tile
    z = np.zeros((n_tiles, PAGE), dtype)
    return _make_seg(z, z.astype(np.int32), np.arange(n_tiles, dtype=np.int64),
                     np.zeros(n_tiles, np.int64), t0, n_tiles)


def _check_x(op, x: torch.Tensor) -> None:
    if x.dim() != 1 or x.shape[0] != op.n_cols:
        raise ValueError(f"x: expected shape ({op.n_cols},), got {tuple(x.shape)}")


def _out_rows(n_out: Optional[int], n_rows: int, n_padded: int) -> int:
    """Rows to return: ``n_out`` (default ``n_rows``) within the padded
    rows the layout writes (zeros past ``n_rows``)."""
    n = n_rows if n_out is None else int(n_out)
    if not 0 <= n <= n_padded:
        raise ValueError(f"n_out={n} outside [0, {n_padded}]")
    return n


def paged_matvec_torch(p: PagedMat, x: torch.Tensor,
                       n_out: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch y = P @ x on any device, in x's dtype (the pass
    semantics of shm3d.solve.pell._seg_matvec_xla and its segment
    concatenation).  Materializes three (T, 1024) temporaries per segment."""
    _check_x(p, x)
    n = _out_rows(n_out, p.n_rows, p.n_tiles * PAGE)
    # whole pages of x (padding passes read page 0 with zero values)
    pad = max(1, -(-p.n_cols // PAGE)) * PAGE - x.shape[0]
    xp = torch.nn.functional.pad(x, (0, pad)) if pad else x
    x2 = xp.reshape(-1, PAGE)
    mask = (1 << _PAGE_BITS) - 1
    parts = []
    for k, s in enumerate(p.segs):
        meta = s.meta.to(torch.int64)
        vals = s.vals.reshape(-1, PAGE).to(x.dtype)
        g = torch.gather(x2.index_select(0, meta & mask), 1,
                         s.idx.reshape(-1, PAGE).to(torch.int64))
        y = torch.zeros(s.n_tiles, PAGE, dtype=x.dtype, device=x.device)
        y.index_add_(0, meta >> _PAGE_BITS, vals * g)
        # a segment's REAL span runs to the next segment's t0 (a JAX-built
        # tree pads n_tiles past it with zero rows)
        if k + 1 < len(p.segs):
            y = y[: p.segs[k + 1].t0 - s.t0]
        parts.append(y)
    y = parts[0] if len(parts) == 1 else torch.cat(parts)
    return y.reshape(-1)[:n]


def _view(a: np.ndarray) -> torch.Tensor:
    """A CPU tensor sharing ``a``'s memory, for reading only (a memory-mapped
    artifact is read-only, which torch warns about on every view)."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="The given NumPy array is not writable")
        return torch.from_numpy(np.ascontiguousarray(a))


def _entries(p: PagedMat):
    """(rows, cols, vals) of a host PagedMat's nonzero slots, in pass order
    (real spans only; vals in the PagedMat's dtype), as numpy arrays.  The
    scans and gathers run in torch on the CPU, which uses every core."""
    rows, cols, vals = [], [], []
    mask = (1 << _PAGE_BITS) - 1
    for s in p.segs:
        T = int(np.asarray(s.tile_ptr)[-1])
        v = _view(s.vals).reshape(-1)[:T * PAGE]
        k = (v != 0).nonzero().reshape(-1)
        mk = _view(s.meta).to(torch.int64).index_select(0, k >> 10)
        idx = _view(s.idx).reshape(-1)
        rows.append(((s.t0 + (mk >> _PAGE_BITS)) << 10) | (k & (PAGE - 1)))
        cols.append(((mk & mask) << 10) | idx.index_select(0, k))
        vals.append(v.index_select(0, k))
    return torch.cat(rows).numpy(), torch.cat(cols).numpy(), torch.cat(vals).numpy()


def to_scipy(p: PagedMat, dtype=np.float64):
    """The matrix a host PagedMat encodes, as canonical scipy CSR (real
    spans only, explicit zeros dropped, columns ascending in each row)."""
    import scipy.sparse as sp

    rows, cols, vals = _entries(p)
    return sp.coo_matrix((vals.astype(dtype, copy=False), (rows, cols)),
                         shape=(p.n_rows, p.n_cols)).tocsr()


def sell_from_csr(M, dtype) -> SellMat:
    """Host-side sliced-ELL build from any scipy sparse matrix (duplicates
    summed; explicit zeros are stored like any entry).  The index work runs
    in torch on the CPU; the leaves come back as numpy arrays."""
    A = M.tocsr()
    A.sum_duplicates()
    A.sort_indices()
    n, m = A.shape
    if m >= (1 << 31):
        raise ValueError(f"sliced ELL stores int32 columns, got {m} columns")
    C = SELL_C
    indptr = torch.from_numpy(np.asarray(A.indptr, np.int64))
    indices = torch.from_numpy(np.asarray(A.indices, np.int32))
    counts = indptr[1:] - indptr[:-1]
    n_slices = max(1, -(-n // C))
    cpad = torch.zeros(n_slices * C, dtype=torch.int64)
    cpad[:n] = counts
    w = cpad.view(n_slices, C).amax(dim=1)
    slice_ptr = torch.zeros(n_slices + 1, dtype=torch.int64)
    torch.cumsum(w * C, 0, out=slice_ptr[1:])
    # padding slots repeat their row's last column, so a gather stays in
    # the row's cache lines: each slice's panel starts as w_s copies of its
    # rows' last columns
    last = torch.zeros(n_slices * C, dtype=torch.int32)
    filled = counts.nonzero().reshape(-1)
    last[filled] = indices.index_select(0, indptr.index_select(0, filled + 1) - 1)
    cols = torch.repeat_interleave(last.view(n_slices, C), w, dim=0).reshape(-1)
    data = torch.from_numpy(np.asarray(A.data, np.dtype(dtype)))
    vals = torch.zeros(cols.shape[0], dtype=data.dtype)
    rows = torch.repeat_interleave(torch.arange(n), counts)
    pos = torch.arange(A.nnz) - indptr.index_select(0, rows)
    slot = slice_ptr.index_select(0, rows // C) + pos * C + rows % C
    vals[slot] = data
    cols[slot] = indices
    return SellMat(vals.numpy(), cols.numpy(), slice_ptr.numpy(), n, m, int(A.nnz))


def to_sell(p: PagedMat) -> SellMat:
    """The sliced-ELL form of a host PagedMat (either package's, padding
    included), in its values' dtype.  A row's entries keep the order in
    which the paged kernel visits them (page, then multiplicity), which is
    ascending column order, so the kernels sum every row the same way."""
    dtype = np.asarray(p.segs[0].vals).dtype
    return sell_from_csr(to_scipy(p, dtype), dtype)


def sell_matvec_torch(s: SellMat, x: torch.Tensor,
                      n_out: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch y = S @ x on any device, in x's dtype: a gather over
    the panel slots and a sum per row (zero slots skipped, as the kernel
    skips them).  Materializes three (n_slots,) temporaries."""
    _check_x(s, x)
    n = _out_rows(n_out, s.n_rows, s.n_slices * SELL_C)
    widths = (s.slice_ptr[1:] - s.slice_ptr[:-1]) // SELL_C
    first = torch.arange(s.n_slices, device=x.device) * SELL_C
    lane = torch.arange(s.n_slots, device=x.device) & (SELL_C - 1)
    slot_row = torch.repeat_interleave(first, widths * SELL_C) + lane
    vals = s.vals.to(x.dtype)
    prod = torch.where(vals != 0, vals * x.index_select(0, s.cols.to(torch.int64)),
                       torch.zeros((), dtype=x.dtype, device=x.device))
    y = torch.zeros(s.n_slices * SELL_C, dtype=x.dtype, device=x.device)
    return y.index_add_(0, slot_row, prod)[:n]


def _check_cuda(name: str, t: torch.Tensor, device: torch.device, dtype) -> None:
    if t.device != device or t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor on {device}, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: the CUDA kernel takes {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def sell_matvec_cuda(s: SellMat, x: torch.Tensor,
                     n_out: Optional[int] = None) -> torch.Tensor:
    """Launch the Hopper kernel once on the current stream (float32; the
    operator's tensors and x on one CUDA device).  Does not synchronize."""
    device = x.device
    _check_cuda("x", x, device, torch.float32)
    _check_x(s, x)
    n = _out_rows(n_out, s.n_rows, s.n_slices * SELL_C)
    _check_cuda("vals", s.vals, device, torch.float32)
    _check_cuda("cols", s.cols, device, torch.int32)
    _check_cuda("slice_ptr", s.slice_ptr, device, torch.int64)
    if s.cols.shape != s.vals.shape:
        raise ValueError("vals and cols must hold one entry per slot")
    y = torch.empty(s.n_slices * SELL_C, dtype=torch.float32, device=device)
    from .._build import load_library

    lib = load_library()
    with torch.cuda.device(device):
        err = lib.shm3d_sell_f32(
            ctypes.c_void_p(s.vals.data_ptr()),
            ctypes.c_void_p(s.cols.data_ptr()),
            ctypes.c_void_p(s.slice_ptr.data_ptr()),
            ctypes.c_void_p(x.data_ptr()),
            ctypes.c_void_p(y.data_ptr()),
            ctypes.c_int64(s.n_slices),
            ctypes.c_int(device.index if device.index is not None
                         else torch.cuda.current_device()),
            ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream),
        )
    if err != 0:
        msg = lib.shm3d_cuda_error_string(err).decode()
        raise RuntimeError(f"sliced-ELL kernel launch failed: {msg} ({err})")
    _count_launch()
    return y[:n]


def _count_launch() -> None:
    """One launch of the kernel: counted now or, while a CUDA graph is
    captured (which launches nothing), at each replay of the graph."""
    global KERNEL_LAUNCHES
    if not graphs.note_launch(__name__, "KERNEL_LAUNCHES"):
        KERNEL_LAUNCHES += 1


def sell_matvec(s: SellMat, x: torch.Tensor,
                n_out: Optional[int] = None) -> torch.Tensor:
    """y = S @ x: the plain version for CPU tensors, the CUDA kernel for
    CUDA tensors (which raises on what it does not take)."""
    if x.device.type == "cpu":
        return sell_matvec_torch(s, x, n_out)
    if x.device.type == "cuda":
        return sell_matvec_cuda(s, x, n_out)
    raise ValueError(f"unsupported device {x.device}")


def apply(op, x: torch.Tensor, n_out: Optional[int] = None) -> torch.Tensor:
    """y = op @ x for any device operator encoding (SellMat, ell.EllMat or
    ell.SlicedEll), or for one split by rows over a device mesh
    (``parallel.rows.RowSharded``: each block applied on its device).  A
    PagedMat is the host form: ``ell.device_put_tree`` turns it into a
    SellMat."""
    if isinstance(op, SellMat):
        return sell_matvec(op, x, n_out)
    if isinstance(op, rows.RowSharded):
        return rows.matvec(op, x, n_out)
    if isinstance(op, PagedMat):
        raise TypeError("PagedMat is the host form; upload it with "
                        "ell.device_put_tree, which converts it to a SellMat")
    if isinstance(op, ell.SlicedEll):
        return ell.sliced_matvec(op, x, n_out=n_out)
    return ell.matvec(op, x, n_out=n_out)
