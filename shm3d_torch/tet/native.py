"""ctypes binding for the native lattice mesher core
(csrc/native/lattice_tet.cpp, csrc/native/exact_conform.cpp).

Loads only the port's own build of those sources, compiled with g++ at first
use by ``shm3d_torch._build.load_native_library``; a failed build raises
with the compiler's log.  There is no quiet NumPy fallback: the meshes must
be the ones the JAX package builds with its native library.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import numpy as np

_LIB = None


def _lib():
    global _LIB
    if _LIB is not None:
        return _LIB
    from .._build import load_native_library

    lib = load_native_library()
    lib.shm3d_lattice_build.restype = ctypes.c_void_p
    lib.shm3d_lattice_build.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
        ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_int,
    ]
    for name in ("nv", "nt", "nsnapped", "nsplit"):
        fn = getattr(lib, f"shm3d_lattice_{name}")
        fn.restype = ctypes.c_int64
        fn.argtypes = [ctypes.c_void_p]
    lib.shm3d_lattice_copy.restype = None
    lib.shm3d_lattice_copy.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.shm3d_lattice_free.restype = None
    lib.shm3d_lattice_free.argtypes = [ctypes.c_void_p]
    _LIB = lib
    return lib


def available() -> bool:
    return _lib() is not None


def conforming_available() -> bool:
    """True when the native library provides conforming surface recovery."""
    lib = _lib()
    return lib is not None and hasattr(lib, "shm3d_conforming_build")


def conforming_build(src_points: np.ndarray, src_faces: np.ndarray,
                     center: np.ndarray, half_side: float, resolution: int):
    """Native conforming build; returns
    (vertices, tets, vertex_of, n_snapped, n_split, surface_tris|None,
    surface_parent|None) or None when unavailable.

    Builder chain (certificates arbitrate each stage):

    1. the tolerance-ladder walk (native/lattice_tet.cpp) — fast and
       produces sliver-free meshes on well-resolved geometry (it welds and
       snaps); succeeds on procedural fixtures;
    2. on certificate failure, the exact-predicate builder
       (native/exact_conform.cpp: quantized integer coordinates + __int128
       orient3d) — recovers reference scans the ladder cannot
       (bunny_small: 43k certified sub-faces); it introduces delta-scale
       slivers by design (the FEM operators carry the matching caps,
       tet/fem.py) and a wall-clock budget (SHM3D_RECOVERY_BUDGET_S,
       default 300 s) after which it cleanly fails into the reference's
       own non-conforming vertex-path fallback
       (signed_heat_tet_solver.cpp:24-33; knot/rocker/chair land there —
       their features under-resolve the lattice and Steiner insertion
       blows up).

    SHM3D_EXACT_RECOVERY=1 forces exact-only; =0 forces ladder-only."""
    lib = _lib()
    if lib is None or not hasattr(lib, "shm3d_conforming_build"):
        return None
    entries = ["shm3d_conforming_build"]
    if hasattr(lib, "shm3d_conforming_build_exact"):
        entries.append("shm3d_conforming_build_exact")
        # the tolerance-ladder walk has never certified a real scan (it
        # welds/snaps its own micro-geometry); skip its doomed attempt on
        # scan-sized inputs (~12 s on knot@96) and go straight to the
        # exact-predicate builder
        if src_faces.shape[0] >= 5000:
            entries = ["shm3d_conforming_build_exact"]
    mode = os.environ.get("SHM3D_EXACT_RECOVERY", "")
    if mode == "0":
        entries = ["shm3d_conforming_build"]
    elif mode == "1":
        entries = [e for e in entries if e.endswith("_exact")] or entries

    out = None
    for i, entry in enumerate(entries):
        out = _conforming_call(lib, entry, src_points, src_faces, center,
                               half_side, resolution,
                               warn=(i == len(entries) - 1))
        if out is not None and out[5] is not None:
            return out
    return out


def _conforming_call(lib, entry, src_points, src_faces, center, half_side,
                     resolution, warn=True):
    pts = np.ascontiguousarray(src_points, dtype=np.float64)
    fcs = np.ascontiguousarray(src_faces, dtype=np.int64)
    V, F = pts.shape[0], fcs.shape[0]
    build_fn = getattr(lib, entry)
    build_fn.restype = ctypes.c_void_p
    build_fn.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_int,
    ]
    lib.shm3d_lattice_nsurf.restype = ctypes.c_int64
    lib.shm3d_lattice_nsurf.argtypes = [ctypes.c_void_p]
    lib.shm3d_lattice_copy_surf.restype = None
    lib.shm3d_lattice_copy_surf.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64)]
    handle = build_fn(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), V,
        fcs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), F,
        float(center[0]), float(center[1]), float(center[2]),
        float(half_side), int(resolution),
    )
    if not handle:
        return None
    try:
        nv = lib.shm3d_lattice_nv(handle)
        nt = lib.shm3d_lattice_nt(handle)
        vertices = np.empty((nv, 3), dtype=np.float64)
        tets = np.empty((nt, 4), dtype=np.int64)
        vertex_of = np.empty(V, dtype=np.int64)
        lib.shm3d_lattice_copy(
            handle,
            vertices.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            tets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            vertex_of.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
        ns = lib.shm3d_lattice_nsurf(handle)
        tris = parents = None
        if ns == 0 and warn and hasattr(lib, "shm3d_lattice_fail_reason"):
            lib.shm3d_lattice_fail_reason.restype = ctypes.c_char_p
            lib.shm3d_lattice_fail_reason.argtypes = [ctypes.c_void_p]
            reason = lib.shm3d_lattice_fail_reason(handle)
            if reason:
                import warnings

                warnings.warn(
                    f"native conforming recovery failed: {reason.decode()}",
                    stacklevel=2)
        if ns > 0:
            tris = np.empty((ns, 3), dtype=np.int64)
            parents = np.empty(ns, dtype=np.int64)
            lib.shm3d_lattice_copy_surf(
                handle,
                tris.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                parents.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            )
        return (vertices, tets, vertex_of,
                int(lib.shm3d_lattice_nsnapped(handle)),
                int(lib.shm3d_lattice_nsplit(handle)), tris, parents)
    finally:
        lib.shm3d_lattice_free(handle)


def lattice_build(src_points: np.ndarray, center: np.ndarray, half_side: float,
                  resolution: int) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray, int, int]]:
    """Returns (vertices, tets, vertex_of, n_snapped, n_split) or None."""
    lib = _lib()
    if lib is None:
        return None
    pts = np.ascontiguousarray(src_points, dtype=np.float64)
    V = pts.shape[0]
    handle = lib.shm3d_lattice_build(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), V,
        float(center[0]), float(center[1]), float(center[2]),
        float(half_side), int(resolution),
    )
    if not handle:
        return None
    try:
        nv = lib.shm3d_lattice_nv(handle)
        nt = lib.shm3d_lattice_nt(handle)
        vertices = np.empty((nv, 3), dtype=np.float64)
        tets = np.empty((nt, 4), dtype=np.int64)
        vertex_of = np.empty(V, dtype=np.int64)
        lib.shm3d_lattice_copy(
            handle,
            vertices.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            tets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            vertex_of.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
        return (vertices, tets, vertex_of,
                int(lib.shm3d_lattice_nsnapped(handle)), int(lib.shm3d_lattice_nsplit(handle)))
    finally:
        lib.shm3d_lattice_free(handle)
