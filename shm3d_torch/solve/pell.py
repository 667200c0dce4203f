"""Paged-ELL SpMV (port of shm3d.solve.pell).

The operator is the JAX package's pass decomposition: matrix entries are
sorted into (output tile, source page) passes, an output tile being 1024
consecutive rows and a source page 1024 consecutive entries of x.  A pass
holds, for one tile, at most one entry per row from one page (rows with
several entries in a page take several passes); slot ``row % 1024`` of a
pass holds the value and the in-page column.  Passes are sorted by tile and
cut into segments of at most ``_SEG_TILES`` tiles and ``_SEG_PASSES``
passes; a pass's meta word is ``local_tile << 20 | page`` with the tile
counted from its segment's ``t0``.

What the port leaves behind: the compile-shape buckets of the TPU build
(``_bucket``, which padded every segment's pass and tile counts up a
geometric grid so compiled kernels could be reused, and ``cols_pad``, the
power-of-two length x was padded to).  The port's ``build_paged`` stores
the real passes only, and the plain version pads x to whole pages.  Trees
built by the JAX package, padding included, are read as they are
(``CRPath.from_prepared``).

- ``paged_matvec_torch``: the plain PyTorch version, the semantics of
  ``_seg_matvec_xla`` (page gather, in-page gather, per-tile sum) and the
  segment concatenation of ``matvec``.
- ``paged_matvec_cuda``: wrapper of the hand-written Hopper kernel
  (``shm3d_torch/csrc/pell.cu``); float32 CUDA tensors only.
- ``paged_matvec`` / ``apply``: dispatch on the tensor's device (CPU tensors
  take the plain version, CUDA tensors launch the kernel or raise) and, for
  ``apply``, on the operator type.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..utils import tree as tree_mod
from . import ell

PAGE = 1024                 # entries per x page / rows per output tile
_SEG_TILES = 2048           # local_tile must fit in 11 bits (i32 sign-safe)
_SEG_PASSES = 150_000       # passes per segment
_PAGE_BITS = 20             # page must fit below the local_tile field

# Launches of the CUDA kernel in this process (incremented by
# ``paged_matvec_cuda`` only, once per launch: one per segment).
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


def _out_rows(p: PagedMat, n_out: Optional[int]) -> int:
    n = p.n_rows if n_out is None else int(n_out)
    if not 0 <= n <= p.n_tiles * PAGE:
        raise ValueError(f"n_out={n} outside [0, {p.n_tiles * PAGE}]")
    return n


def _check_x(p: PagedMat, x: torch.Tensor) -> None:
    if x.dim() != 1 or x.shape[0] != p.n_cols:
        raise ValueError(f"x: expected shape ({p.n_cols},), got {tuple(x.shape)}")


def paged_matvec_torch(p: PagedMat, x: torch.Tensor,
                       n_out: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch y = P @ x on any device, in x's dtype (the pass
    semantics of shm3d.solve.pell._seg_matvec_xla and its segment
    concatenation).  Materializes three (T, 1024) temporaries per segment."""
    _check_x(p, x)
    n = _out_rows(p, n_out)
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


def _check_cuda(name: str, t: torch.Tensor, device: torch.device, dtype) -> None:
    if t.device != device or t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor on {device}, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: the CUDA kernel takes {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def paged_matvec_cuda(p: PagedMat, x: torch.Tensor,
                      n_out: Optional[int] = None) -> torch.Tensor:
    """Launch the Hopper kernel once per segment on the current stream
    (float32; the operator's tensors and x on one CUDA device).  Does not
    synchronize."""
    global KERNEL_LAUNCHES
    device = x.device
    _check_cuda("x", x, device, torch.float32)
    _check_x(p, x)
    n = _out_rows(p, n_out)
    for s in p.segs:
        _check_cuda("vals", s.vals, device, torch.float32)
        _check_cuda("idx", s.idx, device, torch.int32)
        _check_cuda("meta", s.meta, device, torch.int32)
        _check_cuda("tile_ptr", s.tile_ptr, device, torch.int64)
        if s.vals.numel() != s.meta.shape[0] * PAGE or s.idx.numel() != s.vals.numel():
            raise ValueError("vals/idx must hold 1024 slots per pass")
    y = torch.empty(p.n_tiles * PAGE, dtype=torch.float32, device=device)
    from .._build import load_library

    lib = load_library()
    dev_index = device.index if device.index is not None else torch.cuda.current_device()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        for s in p.segs:
            # each segment writes its own span of y: [t0, t0 + span) tiles
            err = lib.shm3d_pell_f32(
                ctypes.c_void_p(s.vals.data_ptr()),
                ctypes.c_void_p(s.idx.data_ptr()),
                ctypes.c_void_p(s.meta.data_ptr()),
                ctypes.c_void_p(s.tile_ptr.data_ptr()),
                ctypes.c_void_p(x.data_ptr()),
                ctypes.c_void_p(y.data_ptr() + s.t0 * PAGE * y.element_size()),
                ctypes.c_int64(int(s.tile_ptr.shape[0]) - 1),
                ctypes.c_int(dev_index),
                ctypes.c_void_p(stream),
            )
            if err != 0:
                msg = lib.shm3d_cuda_error_string(err).decode()
                raise RuntimeError(f"paged-ELL kernel launch failed: {msg} ({err})")
            KERNEL_LAUNCHES += 1
    return y[:n]


def paged_matvec(p: PagedMat, x: torch.Tensor,
                 n_out: Optional[int] = None) -> torch.Tensor:
    """y = P @ x: the plain version for CPU tensors, the CUDA kernel for
    CUDA tensors (which raises on what it does not take)."""
    if x.device.type == "cpu":
        return paged_matvec_torch(p, x, n_out)
    if x.device.type == "cuda":
        return paged_matvec_cuda(p, x, n_out)
    raise ValueError(f"unsupported device {x.device}")


def apply(op, x: torch.Tensor, n_out: Optional[int] = None) -> torch.Tensor:
    """y = op @ x for any operator encoding (ell.EllMat, ell.SlicedEll or
    PagedMat)."""
    if isinstance(op, PagedMat):
        return paged_matvec(op, x, n_out)
    if isinstance(op, ell.SlicedEll):
        return ell.sliced_matvec(op, x, n_out=n_out)
    return ell.matvec(op, x, n_out=n_out)


def to_scipy(p: PagedMat):
    """The matrix a host PagedMat encodes, as scipy CSR (real spans only)."""
    import scipy.sparse as sp

    rows, cols, vals = [], [], []
    mask = (1 << _PAGE_BITS) - 1
    for s in p.segs:
        meta = np.asarray(s.meta).astype(np.int64)
        tp = np.asarray(s.tile_ptr)
        T = int(tp[-1])
        v = np.asarray(s.vals).reshape(-1, PAGE)[:T]
        c = np.asarray(s.idx).reshape(-1, PAGE)[:T].astype(np.int64)
        pid, slot = np.nonzero(v)
        rows.append((s.t0 + (meta[pid] >> _PAGE_BITS)) * PAGE + slot)
        cols.append((meta[pid] & mask) * PAGE + c[pid, slot])
        vals.append(v[pid, slot].astype(np.float64))
    A = sp.coo_matrix((np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
                      shape=(p.n_rows, p.n_cols))
    return A.tocsr()
