"""On-disk operator cache: discretization artifacts keyed by content.

The reference retains discretization + factorizations across solves inside
one process via its ``rebuild`` flag (reference src/main.cpp:113,
146-147; README.md:73 "future computations can be significantly faster").
shm3d's in-memory keyed cache already replaces that contract; this module
extends it ACROSS processes (SURVEY.md §5.4 "optionally serialized"): cold
CLI runs reuse host precompute — source quadrature, constraint rows, the
orthonormalized Gram factor — which costs tens of seconds on a single-core
host (e.g. 52k-point tufted weights + a 4k x 4k eigh for the 128^3 bench
config).

Artifacts are plain ``np.savez`` archives under ``$SHM3D_CACHE_DIR``
(default ``~/.cache/shm3d``), named by a sha256 over (geometry content,
options cache key, artifact schema version).  Only numpy arrays are
stored; factorization handles (splu) are rebuilt from the stored arrays at
load time (cheap).  Writes go through a temp file + rename so concurrent
processes never observe partial archives.
"""

from __future__ import annotations

import hashlib
import os
import tempfile
from typing import Dict, Optional

import numpy as np

# bump when the artifact schema or any producer algorithm changes
CACHE_VERSION = "g2"


def cache_dir() -> str:
    return os.environ.get(
        "SHM3D_CACHE_DIR", os.path.join(os.path.expanduser("~"), ".cache", "shm3d")
    )


def geometry_content_hash(geom) -> str:
    """sha256 over the raw geometry arrays (mesh vertices+faces or point
    cloud positions+normals) — computable before any preprocessing, so the
    preprocessing itself can live in the cache."""
    h = hashlib.sha256()
    for name in ("vertices", "faces", "positions", "normals"):
        a = getattr(geom, name, None)
        if a is not None:
            a = np.ascontiguousarray(a)
            h.update(name.encode())
            h.update(str(a.shape).encode())
            h.update(a.tobytes())
    return h.hexdigest()[:24]


def _path(key_parts) -> str:
    h = hashlib.sha256()
    for part in key_parts:
        h.update(repr(part).encode())
    h.update(CACHE_VERSION.encode())
    return os.path.join(cache_dir(), f"{h.hexdigest()[:32]}.npz")


def load(key_parts) -> Optional[Dict[str, np.ndarray]]:
    path = _path(key_parts)
    if not os.path.exists(path):
        return None
    try:
        with np.load(path, allow_pickle=False) as z:
            return {k: z[k] for k in z.files}
    except Exception:
        # corrupt/foreign file: ignore (it will be overwritten)
        return None


def save(key_parts, arrays: Dict[str, np.ndarray]) -> None:
    path = _path(key_parts)
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".tmp")
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    except OSError:
        pass  # cache is best-effort (read-only FS, disk full, ...)
