"""SourceDistribution: the unified array contract for signed-heat sources.

The reference has three input flavors — triangle-mesh faces, polygon faces,
and oriented points — handled by separate C++ overloads
(reference src/signed_heat_tet_solver.cpp:7,93;
reference src/signed_heat_grid_solver.cpp:5,116).  All three collapse to
the same Step-1 summation
``X(q) = sum_s  n_s * w_s * exp(-lambda |p_s - q|) / |p_s - q|``
over quadrature sources {point p_s, unit normal n_s, weight w_s}
(1-point quadrature per face: barycenter + area, or per point: position +
tufted dual area).  This dataclass is that contract; everything downstream
(the Pallas kernel, the oracle, the sharded path) consumes it.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional

import numpy as np

from ..io.mesh_io import Mesh, PointCloud
from . import pointcloud as pc_geom
from . import surface as surf


@dataclasses.dataclass
class SourceDistribution:
    """points (S,3), normals (S,3) unit, weights (S,) — all float64 host arrays.

    ``spacing`` is the mesh-dependent length heuristic h used for the
    diffusion time t = tCoef * h^2 (grid path:
    reference src/signed_heat_grid_solver.cpp:42-44,149-152).  The tet
    path overrides it with the tet-mesh mean node spacing
    (reference src/signed_heat_tet_solver.cpp:37-38).
    """

    points: np.ndarray
    normals: np.ndarray
    weights: np.ndarray
    spacing: float

    @property
    def n_sources(self) -> int:
        return int(self.points.shape[0])

    def vectors(self) -> np.ndarray:
        """(S, 3) area-weighted normal vectors n_s * w_s."""
        return self.normals * self.weights[:, None]

    def content_hash(self) -> str:
        h = hashlib.sha256()
        for a in (self.points, self.normals, self.weights):
            h.update(np.ascontiguousarray(a).tobytes())
        h.update(np.float64(self.spacing).tobytes())
        return h.hexdigest()[:16]


def from_mesh(mesh: Mesh) -> SourceDistribution:
    """Faces -> 1-point quadrature at barycenters with shoelace vector areas
    (reference Step-1 inner loop, signed_heat_grid_solver.cpp:53-58).
    Handles triangle and polygon meshes identically (always-shoelace quirk,
    SURVEY.md §7 'behavioral quirks')."""
    areas, normals = surf.face_vector_areas(mesh)
    barys = surf.face_barycenters(mesh)
    h = surf.mean_edge_length(mesh)
    return SourceDistribution(barys, normals, areas, h)


def from_point_cloud(cloud: PointCloud, k: int = pc_geom._K_NEIGHBORS) -> SourceDistribution:
    """Oriented points -> quadrature with tufted-style dual-area weights
    (reference: signed_heat_grid_solver.cpp:162-167)."""
    tri = pc_geom.local_triangulation(cloud.positions, k)
    normals = cloud.normals / np.linalg.norm(cloud.normals, axis=1, keepdims=True)
    return SourceDistribution(cloud.positions, normals, tri.dual_areas, tri.mean_edge_length)


def from_geometry(geom) -> SourceDistribution:
    if isinstance(geom, Mesh):
        return from_mesh(geom)
    if isinstance(geom, PointCloud):
        return from_point_cloud(geom)
    raise TypeError(f"unsupported geometry type: {type(geom)}")
