"""Trees of the port's operator types (NamedTuples and dataclasses whose
leaves are arrays): transfer to a device, adoption of the JAX package's
trees by field name, and a plain form for the on-disk artifact store.

The port's operator types carry the same names and fields as their
``shm3d`` counterparts (``EllMat``, ``PagedMat``, ``AMGHierarchy``, ...).
They go into the port's own treestore (``shm3d_torch.utils.treestore``) as
dicts tagged with their class name (:func:`to_plain` / :func:`from_plain`),
the disk form the port's artifacts have always had.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np

_TYPES: Dict[str, type] = {}
_TAG = "__type__"


def register(cls: type) -> type:
    """Class decorator: make ``cls`` a tree node of the port."""
    _TYPES[cls.__name__] = cls
    return cls


def _fields(cls) -> tuple:
    if hasattr(cls, "_fields"):
        return cls._fields
    return tuple(f.name for f in dataclasses.fields(cls))


def _port_type(obj):
    cls = type(obj)
    return cls if _TYPES.get(cls.__name__) is cls else None


def map_arrays(fn: Callable, tree, node: Optional[Callable] = None):
    """``tree`` with every numpy-array leaf replaced by ``fn(leaf)``; scalars
    and foreign objects (e.g. a TetMesh) are left as they are.  ``node``,
    when given, rewrites each port-type node before its leaves are mapped;
    a node it turns into anything but a port type is taken as it is."""
    if isinstance(tree, np.ndarray):
        return fn(tree)
    cls = _port_type(tree)
    if cls is not None:
        if node is not None:
            tree = node(tree)
            cls = _port_type(tree)
            if cls is None:
                return tree
        return cls(**{k: map_arrays(fn, getattr(tree, k), node) for k in _fields(cls)})
    if isinstance(tree, dict):
        return {k: map_arrays(fn, v, node) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(map_arrays(fn, v, node) for v in tree)
    return tree


def adopt(tree):
    """The same tree built from the port's types: every NamedTuple or
    dataclass whose class name is a port type is rebuilt from its fields
    read by name (fields the port does not have are dropped, fields the
    source lacks take the port type's default)."""
    cls = _TYPES.get(type(tree).__name__)
    if cls is not None and (hasattr(tree, "_fields") or dataclasses.is_dataclass(tree)):
        return cls(**{k: adopt(getattr(tree, k)) for k in _fields(cls)
                      if hasattr(tree, k)})
    if isinstance(tree, dict):
        return {k: adopt(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(adopt(v) for v in tree)
    return tree


def to_plain(tree):
    """Port-type nodes as dicts tagged with their class name (storable by
    ``shm3d.utils.treestore``)."""
    cls = _port_type(tree)
    if cls is not None:
        out = {k: to_plain(getattr(tree, k)) for k in _fields(cls)}
        out[_TAG] = cls.__name__
        return out
    if isinstance(tree, dict):
        return {k: to_plain(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(to_plain(v) for v in tree)
    return tree


def from_plain(tree):
    """Inverse of :func:`to_plain`."""
    if isinstance(tree, dict):
        d = {k: from_plain(v) for k, v in tree.items()}
        name = d.pop(_TAG, None)
        return d if name is None else _TYPES[name](**d)
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(from_plain(v) for v in tree)
    return tree
