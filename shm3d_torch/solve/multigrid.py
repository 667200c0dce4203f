"""Geometric multigrid preconditioner for the 7-point grid Laplacian (port
of shm3d.solve.multigrid).

Weighted Jacobi (omega = 2/3) on H = -L, separable full-weighting
restriction and cell-centred linear prolongation (its adjoint up to 1/8),
rediscretized coarse operators, and the dense pseudo-inverse or 40 Jacobi
sweeps on the coarsest level.  With pin masks every level smooths on
H + diag(mask * 6/cell^2), a Dirichlet penalty at the constraint surface
that makes the V-cycle close to the projected operator the outer CG solves.

On a level held as one CUDA tensor, each smoothing pass and residual
is one launch of the fused kernels of ``csrc/mg_stencil.cu``
(``stencil_cuda``; a level that fits one block runs all of its sweeps in
one launch), and ``stencil_cuda`` raises on a CUDA level they cannot take
(not a contiguous float32 or float64 cube): there is no fallback on the
card.  Elsewhere (CPU tensors, z-slabs) the plain ops run, the kernels'
twin: both give the same bits.  Restriction and prolongation are plain ops
on every device.

All functions are out of place: no caller's tensor is modified.  The slab
V-cycle (``v_cycle_slabs``) runs the same cycle on a mesh of z-slabs.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..ops import stencil
from ..parallel import slab
from ..parallel.shards import Shards, halo_planes
from . import graphs

_OMEGA = 2.0 / 3.0

# Launches of the fused stencil kernels (``stencil_cuda``), counted at each
# run of a CUDA graph that holds one: 13 a pinned V-cycle over five levels
# (three a level above the coarsest, one there), one a Laplacian.
STENCIL_LAUNCHES = 0

# the most nodes a level may have for all of its sweeps to run in one
# launch (csrc/mg_stencil.cu: ONE_MAX_NODES)
ONE_LAUNCH_NODES = 4096

# the kernels' ops (csrc/mg_stencil.cu: LAPLACIAN, RESIDUAL, SWEEP)
_OPS = {"laplacian": 0, "residual": 1, "jacobi": 2}


# copied from shm3d/solve/multigrid.py (_coarse_pinv_unit)
@functools.lru_cache(maxsize=8)
def _coarse_pinv_unit(n: int) -> np.ndarray:
    """Dense pseudo-inverse of the unit-cell-size coarse operator H = -L on
    an (n, n, n) grid (mirrored boundaries), as a host float64 array.  The
    null constant mode is truncated, keeping the result symmetric PSD (a
    valid MINRES/CG preconditioner block)."""
    from ..domains import grid as griddom

    spec = griddom.GridSpec((0.0, 0.0, 0.0), 1.0, n)
    H = -griddom.laplacian_matrix(spec).toarray()
    lam, Q = np.linalg.eigh(H)
    inv = np.where(lam > 1e-8 * lam[-1], 1.0 / np.maximum(lam, 1e-300), 0.0)
    return (Q * inv) @ Q.T


@functools.lru_cache(maxsize=None)
def _coarse_pinv(n: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``_coarse_pinv_unit`` resident on ``device`` (copied there once; to a
    card from pinned memory without a host sync, so a first V-cycle may run
    in a CUDA graph's warm-up, where a sync raises).  Never evicted: a CUDA
    graph that captured a V-cycle reads it by address."""
    host = torch.as_tensor(_coarse_pinv_unit(n), dtype=dtype)
    if torch.device(device).type != "cuda":
        return host.to(device)
    return host.pin_memory().to(device, non_blocking=True)


def fused(u) -> bool:
    """The fused kernels take ``u``: one tensor on a CUDA device (z-slabs,
    ``Shards`` or lists, and CPU tensors keep the plain ops)."""
    return isinstance(u, torch.Tensor) and u.is_cuda


def _scalars(cell: float, dtype: torch.dtype):
    """The kernels' scalars, each as ATen's CUDA kernels take the plain ops'
    Python scalar: a factor cast to the tensor's type, a division by a
    scalar a product with its reciprocal, taken in float64 and then cast.
    (1 / cell^2, the penalty scale and diagonal 6 / cell^2, omega,
    1 / (6 / cell^2))."""
    t = np.float32 if dtype == torch.float32 else np.float64
    diag = _H_diag(cell)
    return t(1.0 / (cell * cell)), t(diag), t(_OMEGA), t(1.0 / diag)


def stencil_cuda(op: str, u, b, cell: float, mask=None, sweeps: int = 1) -> torch.Tensor:
    """One level's ``op`` on the current stream, one launch (``jacobi``
    past ONE_LAUNCH_NODES nodes: one a sweep); does not synchronize.
    ``laplacian``: L u.  ``residual``: b - (H u + w u), w = mask *
    6 / cell^2 (mask None: w = 0).  ``jacobi``: ``sweeps`` sweeps on
    H + diag(w) from u (None: zero).  Each bit for bit its plain version
    (``stencil.laplacian_apply``, ``b - _Hp_apply``, ``_jacobi``)."""
    global STENCIL_LAUNCHES
    given = [(name, t) for name, t in (("u", u), ("b", b), ("mask", mask)) if t is not None]
    first, ref = given[0]
    for name, t in given:
        if t.dtype not in (torch.float32, torch.float64) or t.dtype != ref.dtype:
            raise TypeError(f"{name}: the stencil kernels take float32 or float64 like "
                            f"{first}, got {t.dtype}")
    for name, t in given:
        if t.dim() != 3 or len(set(t.shape)) != 1 or t.shape != ref.shape:
            raise ValueError(f"{name}: expected an (n, n, n) level like {first}, "
                             f"got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous tensor")
    for name, t in given:
        if t.device.type != "cuda" or t.device != ref.device:
            raise ValueError(f"{name}: expected a CUDA tensor on {ref.device}, got {t.device}")
    if (u is None and op != "jacobi") or (b is None and op != "laplacian") or sweeps < 1:
        raise ValueError(f"{op}: missing operands or sweeps {sweeps} < 1")
    n, device = int(ref.shape[0]), ref.device
    launches = 1
    if op == "jacobi" and sweeps > 1 and n ** 3 > ONE_LAUNCH_NODES:
        launches, sweeps = sweeps, 1
    from .._build import load_library

    lib = load_library()
    if ref.dtype == torch.float32:
        entry, scalar = lib.shm3d_mg_stencil_f32, ctypes.c_float
    else:
        entry, scalar = lib.shm3d_mg_stencil_f64, ctypes.c_double
    coeffs = [scalar(float(c)) for c in _scalars(cell, ref.dtype)]
    index = device.index if device.index is not None else torch.cuda.current_device()

    def ptr(t):
        return ctypes.c_void_p(None if t is None else t.data_ptr())

    with torch.cuda.device(device):
        stream = ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
        for _ in range(launches):
            out = torch.empty_like(ref)
            err = entry(_OPS[op], ptr(u), ptr(b), ptr(mask), ptr(out), ctypes.c_int64(n),
                        *coeffs, ctypes.c_int(sweeps), ctypes.c_int(index), stream)
            if err != 0:
                msg = lib.shm3d_cuda_error_string(err).decode()
                raise RuntimeError(f"stencil kernel launch ({op}) failed: {msg} ({err})")
            if not graphs.note_launch(__name__, "STENCIL_LAUNCHES"):
                STENCIL_LAUNCHES += 1
            u = out
    return out


def _Hp_apply(u, cell, w):
    """H + diag(w): the penalized operator the pin-aware V-cycle targets
    (``w`` None -> plain H)."""
    r = -stencil.laplacian_apply(u, cell)
    return r if w is None else r + w * u


def _H_diag(cell):
    """Constant interior diagonal 6/cell^2 (the exact boundary-corrected
    diagonal would make the smoother non-self-adjoint)."""
    return 6.0 / (cell * cell)


def _jacobi(u, b, cell, diag, sweeps: int, w=None):
    d = diag if w is None else diag + w
    for _ in range(sweeps):
        u = u + _OMEGA * (b - _Hp_apply(u, cell, w)) / d
    return u


def _restrict_axis(r, ax: int, lo=None, hi=None):
    """``restrict`` along one axis.  ``lo`` / ``hi``: along axis 0 of a
    z-slab, the previous slab's last plane and the next slab's first (None
    at the domain's ends, where the clamped-boundary terms apply)."""
    r = r.movedim(ax, 0)
    even, odd = r[0::2], r[1::2]
    c = 0.75 * (even + odd)  # a new tensor: the updates below are local
    if lo is None:
        c[1:] += 0.25 * odd[:-1]
    else:
        c += 0.25 * torch.cat([lo, odd[:-1]])
    if hi is None:
        c[:-1] += 0.25 * even[1:]
    else:
        c += 0.25 * torch.cat([even[1:], hi])
    # clamped-boundary contributions (mirror of the prolongation clamp)
    if lo is None:
        c[0] += 0.25 * even[0]
    if hi is None:
        c[-1] += 0.25 * odd[-1]
    return (0.5 * c).movedim(0, ax)


def restrict(r: torch.Tensor) -> torch.Tensor:
    """(n, n, n) -> (n/2, n/2, n/2): adjoint of ``prolong`` scaled by 1/8
    (separable full weighting; constants restrict to constants)."""
    for ax in range(3):
        r = _restrict_axis(r, ax)
    return r.contiguous()


def _prolong_axis(e, ax: int, lo=None, hi=None):
    """``prolong`` along one axis; ``lo`` / ``hi`` as in ``_restrict_axis``
    (the clamp applies where they are None)."""
    e = e.movedim(ax, 0)
    m = e.shape[0]
    left = torch.cat([e[:1] if lo is None else lo, e[:-1]], dim=0)
    right = torch.cat([e[1:], e[-1:] if hi is None else hi], dim=0)
    out = torch.empty((2 * m,) + tuple(e.shape[1:]), dtype=e.dtype, device=e.device)
    out[0::2] = 0.75 * e + 0.25 * left
    out[1::2] = 0.75 * e + 0.25 * right
    return out.movedim(0, ax)


def prolong(e: torch.Tensor) -> torch.Tensor:
    """(m, m, m) -> (2m, 2m, 2m) separable cell-centred linear interpolation
    (weights 3/4, 1/4; clamped at the mirrored boundaries)."""
    for ax in range(3):
        e = _prolong_axis(e, ax)
    return e.contiguous()


def _level_ops(b: torch.Tensor, cell: float, mask):
    """(smooth, residual) of one level on H + diag(w), w = mask * 6/cell^2
    (mask None: w = 0): ``smooth(u, sweeps)`` from u (None: zero) and
    ``residual(u)`` = b - (H + diag(w)) u; the fused kernels on a CUDA
    level (``fused``), else the plain ops."""
    if fused(b):
        return (lambda u, sweeps: stencil_cuda("jacobi", u, b, cell, mask, sweeps),
                lambda u: stencil_cuda("residual", u, b, cell, mask))
    w = None if mask is None else mask * (6.0 / (cell * cell))
    diag = _H_diag(cell)
    return (lambda u, sweeps: _jacobi(torch.zeros_like(b) if u is None else u, b, cell,
                                      diag, sweeps, w),
            lambda u: b - _Hp_apply(u, cell, w))


def v_cycle(b: torch.Tensor, cell: float, nu: int = 1, coarsest: int = 8, pins=None):
    """One symmetric V-cycle approximating H^{-1} b, H = -L at spacing
    ``cell``; ``b`` is (n, n, n).  ``pins``: optional tuple of per-level
    penalty masks in [0, 1] (level 0 first; ``build_pin_masks``)."""
    n = b.shape[0]
    mask = pins[0] if pins else None
    pins_c = None if pins is None else pins[1:]
    if n <= coarsest and n <= 16 and mask is None:
        # dense pinv: 16^3 -> a 4096^2 matvec
        pinv = _coarse_pinv(n, b.dtype, b.device)
        return (cell * cell) * (pinv @ b.reshape(-1)).reshape(b.shape)
    smooth, residual = _level_ops(b, cell, mask)
    if n <= coarsest:
        return smooth(None, 40)
    if n % 2:
        # odd resolution (fractional hCoef): cannot 2x-coarsen; smooth only
        return smooth(None, 20)
    u = smooth(None, nu)
    e = v_cycle(restrict(residual(u)), 2.0 * cell, nu, coarsest, pins_c)
    return smooth(u + prolong(e), nu)


def build_pin_masks(nodes8: torch.Tensor, shape, dtype: torch.dtype,
                    coarsest: int = 8):
    """Per-level pin masks for the penalized V-cycle, in the compute dtype:
    1 at every node a constraint row touches on the fine grid, restricted
    down the hierarchy (x8, clipped to [0, 1]).  Level 0 first."""
    N = int(np.prod(shape))
    m0 = torch.zeros(N, dtype=dtype, device=nodes8.device)
    m0[nodes8.reshape(-1)] = 1.0
    masks = [m0.reshape(shape)]
    n = shape[0]
    while n > coarsest and n % 2 == 0:
        masks.append(torch.clamp(restrict(masks[-1]) * 8.0, 0.0, 1.0))
        n //= 2
    return tuple(masks)


def make_node_preconditioner(shape, cell: float, pins=None):
    """One V-cycle as a preconditioner on flat (N,) node vectors, or on
    their z-slabs (``Shards``; ``pins`` from ``build_slab_pin_masks``)."""

    def precond(r_flat):
        if isinstance(r_flat, Shards):
            n = shape[0]
            slabs = [p.reshape(-1, n, n) for p in r_flat.parts]
            out = v_cycle_slabs(slabs, cell, pins=pins)
            return Shards([o.reshape(-1) for o in out], r_flat.mesh)
        return v_cycle(r_flat.reshape(shape), cell, pins=pins).reshape(-1)

    return precond


# --- the V-cycle on z-slabs ----------------------------------------------
#
# Each shard holds (nz, n, n) planes of a level.  The smoother, the residual,
# restrict and prolong run on the slabs with one-plane halos
# (shards.halo_planes) and take every node through the single-device
# operations in their order; restrict's clamped-boundary terms and prolong's
# clamp apply at the domain's ends only.  Below the level where a slab would
# not restrict to whole planes, or at the coarsest, the level is gathered to
# the first shard's device, the single-device remainder runs there and the
# correction is scattered back.  So one slab V-cycle is bitwise equal to
# ``v_cycle`` on one device of the same type.


def _slab_level(n: int, nz: int, coarsest: int) -> bool:
    """A level of n^3 nodes, nz planes a slab, runs on the slabs."""
    return n > coarsest and nz % 2 == 0


def slab_gather_level(n: int, n_shards: int, coarsest: int = 8):
    """(level, n at that level) where the slab V-cycle gathers; level 0 is
    the finest."""
    level, nz = 0, n // n_shards
    while _slab_level(n, nz, coarsest):
        level, n, nz = level + 1, n // 2, nz // 2
    return level, n


def _Hp_slabs(u, cell, w):
    r = [-x for x in slab.laplacian_apply(u, cell)]
    return r if w is None else [rk + wk * uk for rk, wk, uk in zip(r, w, u)]


def _jacobi_slabs(u, b, cell, diag, sweeps: int, w=None):
    d = [diag] * len(u) if w is None else [diag + wk for wk in w]
    for _ in range(sweeps):
        Hu = _Hp_slabs(u, cell, w)
        u = [uk + _OMEGA * (bk - hk) / dk for uk, bk, hk, dk in zip(u, b, Hu, d)]
    return u


def restrict_slabs(parts):
    """``restrict`` of an (n, n, n) field held as z-slabs of an even number
    of planes each."""
    lo, hi = halo_planes(parts)
    out = []
    for r, below, above in zip(parts, lo, hi):
        r = _restrict_axis(r, 0, below, above)
        for ax in (1, 2):
            r = _restrict_axis(r, ax)
        out.append(r.contiguous())
    return out


def prolong_slabs(parts):
    """``prolong`` of an (m, m, m) field held as z-slabs."""
    lo, hi = halo_planes(parts)
    out = []
    for e, below, above in zip(parts, lo, hi):
        e = _prolong_axis(e, 0, below, above)
        for ax in (1, 2):
            e = _prolong_axis(e, ax)
        out.append(e.contiguous())
    return out


def _gather(parts):
    first = parts[0].device
    return torch.cat([p.to(first) for p in parts])


def v_cycle_slabs(b, cell: float, nu: int = 1, coarsest: int = 8, pins=None):
    """``v_cycle`` on z-slabs: ``b`` is a list of (nz, n, n) slabs, one per
    shard in order; ``pins`` from ``build_slab_pin_masks``.  Returns the
    correction as slabs on the same devices."""
    nz = b[0].shape[0]
    if not _slab_level(nz * len(b), nz, coarsest):
        e = v_cycle(_gather(b), cell, nu, coarsest, pins)
        return [blk.to(x.device) for blk, x in zip(torch.split(e, nz), b)]
    w = None
    if pins is not None and len(pins) > 0:
        w = [m * (6.0 / (cell * cell)) for m in pins[0]]
        pins_c = pins[1:]
    else:
        pins_c = None if pins is None else ()
    diag = _H_diag(cell)
    u = _jacobi_slabs([torch.zeros_like(x) for x in b], b, cell, diag, nu, w)
    r = [bk - hk for bk, hk in zip(b, _Hp_slabs(u, cell, w))]
    e = v_cycle_slabs(restrict_slabs(r), 2.0 * cell, nu, coarsest, pins_c)
    u = [uk + pk for uk, pk in zip(u, prolong_slabs(e))]
    return _jacobi_slabs(u, b, cell, diag, nu, w)


def build_slab_pin_masks(nodes8: torch.Tensor, n: int, mesh, dtype: torch.dtype,
                         coarsest: int = 8):
    """``build_pin_masks`` for the slab V-cycle: each shard marks its own
    nodes; a level that runs on the slabs is a list of (nz, n, n) slabs,
    the gathered levels below it full tensors on the first device."""
    nz = n // len(mesh)
    size = nz * n * n
    flat = np.unique(nodes8.reshape(-1).cpu().numpy())
    level = []
    for k, dev in enumerate(mesh.devices):
        m = torch.zeros(size, dtype=dtype, device=dev)
        own = flat[(flat >= k * size) & (flat < (k + 1) * size)] - k * size
        m[torch.as_tensor(own, device=dev)] = 1.0
        level.append(m.reshape(nz, n, n))
    masks = []
    while True:
        if isinstance(level, list) and not _slab_level(n, nz, coarsest):
            level = _gather(level)
        masks.append(level)
        if not (n > coarsest and n % 2 == 0):
            break
        if isinstance(level, list):
            level = [torch.clamp(x * 8.0, 0.0, 1.0) for x in restrict_slabs(level)]
        else:
            level = torch.clamp(restrict(level) * 8.0, 0.0, 1.0)
        n, nz = n // 2, nz // 2
    return tuple(masks)
