"""Directory-based, memory-mapped pytree store for prepared solver state.

The reference keeps its discretization + factorizations in solver members
across solves (reference include/signed_heat_tet_solver.h:37-60,
README.md:73); shm3d extends that contract across processes.  Round 2 stored
raw host arrays in one ``np.savez`` archive and re-derived everything else at
load (ELL panels, AMG hierarchies, projection Gram products) — on this
single-core host that re-derivation PLUS the monolithic-archive read cost
~61 s per warm knot load.  This store instead
persists the FULLY PREPARED state — final-dtype device panels, AMG levels,
host f64 CSR operators — as one ``.npy`` file per array leaf in a keyed
directory:

- loads are ``np.load(mmap_mode="r")``: opening the artifact costs
  milliseconds, and only the arrays a solve actually touches are paged in;
- device transfer reads straight from the page cache into one batched
  ``jax.device_put`` (solve/ell.device_put_tree);
- writes go to a temp directory + atomic rename, so concurrent processes
  never observe partial artifacts.

Supported leaves: ``np.ndarray`` (stored as .npy) and JSON scalars
(int/float/str/bool/None, stored in the manifest).  Supported containers:
dict (str keys), list, tuple, and REGISTERED NamedTuple / dataclass types
(the registry keeps unpickling explicit and safe — no pickle anywhere).
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import tempfile
from typing import Any, Dict, Optional

import numpy as np

from . import diskcache

#: bump when the prepared-artifact layout or any producer algorithm changes
TREE_VERSION = "t7"  # t7: dual-Laplacian negative-diagonal repair

# name -> class; classes opt in to serialization explicitly so manifests can
# never instantiate arbitrary types
_REGISTRY: Dict[str, type] = {}
# name -> (pack, unpack): optional compact on-disk encodings.  pack(obj)
# returns a plain tree (dicts/arrays/scalars); unpack(tree) rebuilds the
# object.  Used where the in-memory layout is deliberately padded (e.g. the
# paged-ELL panels are ~16%-occupied dense passes: solve/pell.py registers a
# nonzero-slot encoding that cuts the knot artifact by ~1.3 GB).  Packed
# leaves are decoded eagerly at load (a scatter), trading the pure-mmap
# laziness for less IO.
_PACKERS: Dict[str, tuple] = {}


def register(cls: type) -> type:
    """Class decorator/function registering a NamedTuple or dataclass for
    tree (de)serialization."""
    _REGISTRY[cls.__name__] = cls
    return cls


def register_packed(cls: type, pack, unpack) -> type:
    """Register a compact on-disk encoding for ``cls`` (see _PACKERS)."""
    _REGISTRY[cls.__name__] = cls
    _PACKERS[cls.__name__] = (pack, unpack)
    return cls


def _is_namedtuple(obj) -> bool:
    return isinstance(obj, tuple) and hasattr(obj, "_fields")


def _encode(obj, leaves: Dict[str, np.ndarray], path: str):
    if isinstance(obj, np.ndarray):
        leaves[path] = obj
        return {"t": "arr", "k": path}
    name = type(obj).__name__
    if name in _PACKERS and not isinstance(obj, type):
        pack, _ = _PACKERS[name]
        return {"t": "packed", "c": name,
                "f": _encode(pack(obj), leaves, f"{path}!")}
    if obj is None or isinstance(obj, (bool, str)):
        return {"t": "val", "v": obj}
    if isinstance(obj, (int, np.integer)):
        return {"t": "val", "v": int(obj)}
    if isinstance(obj, (float, np.floating)):
        return {"t": "val", "v": float(obj)}
    if _is_namedtuple(obj):
        name = type(obj).__name__
        if name not in _REGISTRY:
            raise TypeError(f"unregistered NamedTuple in tree: {name}")
        return {"t": "nt", "c": name,
                "f": {k: _encode(v, leaves, f"{path}.{k}")
                      for k, v in obj._asdict().items()}}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        name = type(obj).__name__
        if name not in _REGISTRY:
            raise TypeError(f"unregistered dataclass in tree: {name}")
        return {"t": "dc", "c": name,
                "f": {f.name: _encode(getattr(obj, f.name), leaves,
                                       f"{path}.{f.name}")
                      for f in dataclasses.fields(obj)}}
    if isinstance(obj, dict):
        return {"t": "dict",
                "f": {str(k): _encode(v, leaves, f"{path}.{k}")
                      for k, v in obj.items()}}
    if isinstance(obj, (list, tuple)):
        return {"t": "tuple" if isinstance(obj, tuple) else "list",
                "f": [_encode(v, leaves, f"{path}[{i}]")
                      for i, v in enumerate(obj)]}
    raise TypeError(f"unsupported leaf in tree at {path}: {type(obj)}")


def _decode(node, arrays):
    t = node["t"]
    if t == "arr":
        return arrays(node["k"])
    if t == "val":
        return node["v"]
    if t == "packed":
        if node["c"] not in _PACKERS:
            raise TypeError(f"unregistered packed class: {node['c']}")
        return _PACKERS[node["c"]][1](_decode(node["f"], arrays))
    if t in ("nt", "dc"):
        cls = _REGISTRY.get(node["c"])
        if cls is None:
            raise TypeError(f"unregistered class in manifest: {node['c']}")
        return cls(**{k: _decode(v, arrays) for k, v in node["f"].items()})
    if t == "dict":
        return {k: _decode(v, arrays) for k, v in node["f"].items()}
    if t == "list":
        return [_decode(v, arrays) for v in node["f"]]
    if t == "tuple":
        return tuple(_decode(v, arrays) for v in node["f"])
    raise TypeError(f"bad manifest node type: {t}")


def _dir_path(key_parts) -> str:
    import hashlib

    h = hashlib.sha256()
    for part in key_parts:
        h.update(repr(part).encode())
    h.update(TREE_VERSION.encode())
    return os.path.join(diskcache.cache_dir(), f"tree_{h.hexdigest()[:32]}")


def save_tree(key_parts, tree) -> Optional[str]:
    """Persist a pytree of numpy arrays + scalars.  Best-effort (returns the
    artifact path, or None when the filesystem refuses)."""
    path = _dir_path(key_parts)
    leaves: Dict[str, np.ndarray] = {}
    manifest = _encode(tree, leaves, "r")
    try:
        os.makedirs(diskcache.cache_dir(), exist_ok=True)
        tmp = tempfile.mkdtemp(dir=diskcache.cache_dir(), suffix=".tmp")
        for i, (k, a) in enumerate(leaves.items()):
            np.save(os.path.join(tmp, f"{i}.npy"), np.ascontiguousarray(a))
        index = {k: f"{i}.npy" for i, k in enumerate(leaves)}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump({"tree": manifest, "arrays": index}, f)
        if os.path.isdir(path):
            shutil.rmtree(path, ignore_errors=True)
        os.replace(tmp, path)
        return path
    except OSError:
        shutil.rmtree(tmp, ignore_errors=True) if "tmp" in dir() else None
        return None


def load_tree(key_parts) -> Any:
    """Load a pytree saved by :func:`save_tree`; arrays come back
    memory-mapped (read-only).  Returns None on miss or corruption."""
    path = _dir_path(key_parts)
    mf = os.path.join(path, "manifest.json")
    if not os.path.exists(mf):
        return None
    try:
        with open(mf) as f:
            manifest = json.load(f)
        index = manifest["arrays"]

        def arrays(key):
            return np.load(os.path.join(path, index[key]), mmap_mode="r",
                           allow_pickle=False)

        return _decode(manifest["tree"], arrays)
    except TypeError:
        # unregistered class: a programming error (import the defining
        # module before loading), not artifact corruption — surface it
        raise
    except Exception:
        return None
