"""Type checks at the port's entry points.

The JAX package's option and geometry classes carry the same names and
fields as the port's, but they are other classes: a JAX-package
``LevelSetConstraint`` member compares unequal to every port member, and a
JAX-package ``Mesh`` fails the port's ``isinstance`` tests (it would be
solved as a point cloud).  So the entry points refuse them instead of
misreading them.
"""

from __future__ import annotations

from .config import SignedHeatOptions
from .io.mesh_io import Mesh, PointCloud


def _name(obj) -> str:
    cls = type(obj)
    return f"{cls.__module__}.{cls.__qualname__}"


def check_inputs(geom, options) -> None:
    """Raise TypeError unless ``options`` and ``geom`` are the port's own
    ``SignedHeatOptions`` and ``Mesh`` / ``PointCloud``."""
    if not isinstance(options, SignedHeatOptions):
        raise TypeError(
            f"options must be shm3d_torch.config.SignedHeatOptions, got {_name(options)}")
    if not isinstance(geom, (Mesh, PointCloud)):
        raise TypeError(
            "geometry must be shm3d_torch.io.mesh_io.Mesh or PointCloud, got "
            f"{_name(geom)}")
