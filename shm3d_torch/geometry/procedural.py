"""Procedural test/demo geometry (fixture source for tests and the demo
entry points; the reference ships static assets in data/ instead, SURVEY.md
§2 C5)."""

from __future__ import annotations

import numpy as np

from ..io.mesh_io import Mesh


def make_icosphere(subdivisions: int = 2, radius: float = 1.0, center=(0.0, 0.0, 0.0)) -> Mesh:
    """Unit icosphere triangle mesh, subdivided by edge midpoint insertion."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        dtype=np.float64,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        dtype=np.int64,
    )
    for _ in range(subdivisions):
        edge_mid = {}
        new_faces = []
        verts_list = [v for v in verts]

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in edge_mid:
                m = verts_list[a] + verts_list[b]
                m /= np.linalg.norm(m)
                edge_mid[key] = len(verts_list)
                verts_list.append(m)
            return edge_mid[key]

        for f in faces:
            a, b, c = int(f[0]), int(f[1]), int(f[2])
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.array(verts_list)
        faces = np.array(new_faces, dtype=np.int64)
    verts = verts * radius + np.asarray(center, dtype=np.float64)
    return Mesh.from_face_lists(verts, [list(f) for f in faces])


def make_sphere_cloud(n: int = 2000, radius: float = 1.0, center=(0.0, 0.0, 0.0)):
    """Oriented point cloud sampling a sphere via the Fibonacci lattice
    (near-uniform density; outward unit normals).  Analytic signed distance
    to the underlying surface is |p - center| - radius, which makes this the
    external validation fixture for point-cloud quadrature weights
    (reference path signed_heat_grid_solver.cpp:146-174)."""
    from ..io.mesh_io import PointCloud

    i = np.arange(n, dtype=np.float64)
    golden = np.pi * (3.0 - np.sqrt(5.0))
    z = 1.0 - 2.0 * (i + 0.5) / n
    rho = np.sqrt(np.maximum(0.0, 1.0 - z * z))
    th = golden * i
    normals = np.stack([rho * np.cos(th), rho * np.sin(th), z], axis=1)
    positions = normals * radius + np.asarray(center, dtype=np.float64)
    return PointCloud(positions, normals.copy())
