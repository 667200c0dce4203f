"""Host-side surface-mesh geometry utilities (NumPy, float64).

Replaces the reference's shared math layer reference src/signed_heat_3d.cpp
(centroid, radius, meanEdgeLength, setFaceVectorAreas) plus the per-face
barycenters used by both solvers.  All functions are vectorized over faces.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..io.mesh_io import Mesh


def centroid(points: np.ndarray) -> np.ndarray:
    """Mean position (reference: signed_heat_3d.cpp:3-12,24-33)."""
    return np.mean(np.asarray(points, dtype=np.float64), axis=0)


def radius(points: np.ndarray, c: np.ndarray) -> float:
    """Max distance from ``c`` (reference: signed_heat_3d.cpp:14-22,35-43)."""
    return float(np.max(np.linalg.norm(points - c[None, :], axis=1)))


def mesh_edges(mesh: Mesh) -> np.ndarray:
    """Unique undirected edges (E, 2) of a polygon mesh: consecutive vertex
    pairs around each face, deduplicated."""
    pairs = []
    F, D = mesh.faces.shape
    for s in range(D):
        nxt = mesh.faces[np.arange(F), (s + 1) % np.maximum(mesh.degrees, 1)]
        valid = s < mesh.degrees
        a = mesh.faces[valid, s]
        b = nxt[valid]
        pairs.append(np.stack([np.minimum(a, b), np.maximum(a, b)], axis=1))
    edges = np.concatenate(pairs, axis=0)
    return np.unique(edges, axis=0)


def mean_edge_length(mesh: Mesh) -> float:
    """Mean length over unique mesh edges (reference: meanEdgeLength,
    signed_heat_3d.cpp:51-60 — geometry-central iterates unique edges)."""
    e = mesh_edges(mesh)
    lengths = np.linalg.norm(mesh.vertices[e[:, 0]] - mesh.vertices[e[:, 1]], axis=1)
    return float(np.mean(lengths))


def face_vector_areas(mesh: Mesh) -> Tuple[np.ndarray, np.ndarray]:
    """Per-face (area, unit normal) via the shoelace formula
    N_f = 1/2 sum_{edges (a,b)} cross(p_a, p_b).

    The reference computes triangle areas/normals then unconditionally
    overwrites them with the shoelace formula (no early return,
    signed_heat_3d.cpp:62-89) — effective behavior is always shoelace, which
    we implement directly.  Returns (areas (F,), normals (F, 3)).
    """
    V = mesh.vertices
    F, D = mesh.faces.shape
    N = np.zeros((F, 3), dtype=np.float64)
    for s in range(D):
        valid = s < mesh.degrees
        if not np.any(valid):
            continue
        a = mesh.faces[:, s]
        b = mesh.faces[np.arange(F), (s + 1) % np.maximum(mesh.degrees, 1)]
        contrib = np.cross(V[np.where(valid, a, 0)], V[np.where(valid, b, 0)])
        N += np.where(valid[:, None], contrib, 0.0)
    N *= 0.5
    areas = np.linalg.norm(N, axis=1)
    normals = N / areas[:, None]
    return areas, normals


def face_barycenters(mesh: Mesh) -> np.ndarray:
    """Degree-aware face barycenters (reference: barycenter(),
    signed_heat_grid_solver.cpp:498-503 and the inline loop in
    signed_heat_tet_solver.cpp:63-66)."""
    V = mesh.vertices
    F, D = mesh.faces.shape
    acc = np.zeros((F, 3), dtype=np.float64)
    for s in range(D):
        valid = s < mesh.degrees
        acc += np.where(valid[:, None], V[np.where(valid, mesh.faces[:, s], 0)], 0.0)
    return acc / mesh.degrees[:, None]


def triangle_areas(vertices: np.ndarray, tris: np.ndarray) -> np.ndarray:
    a, b, c = vertices[tris[:, 0]], vertices[tris[:, 1]], vertices[tris[:, 2]]
    return 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=1)


def vertex_dual_areas(mesh: Mesh) -> np.ndarray:
    """Barycentric vertex dual areas: 1/3 of incident triangle areas
    (geometry-central ``vertexDualAreas``; used for the mean shift along the
    source at signed_heat_tet_solver.cpp:575-589).  Triangular meshes only."""
    tris = mesh.triangles()
    areas = triangle_areas(mesh.vertices, tris)
    dual = np.zeros(mesh.n_vertices, dtype=np.float64)
    for k in range(3):
        np.add.at(dual, tris[:, k], areas / 3.0)
    return dual


def vertex_normals(mesh: Mesh) -> np.ndarray:
    """Unit area-weighted vertex normals of a triangle mesh (the sum of the
    incident faces' vector areas, normalised): what turns a mesh's vertices
    into an oriented point cloud."""
    tris, v = mesh.triangles(), mesh.vertices
    fn = np.cross(v[tris[:, 1]] - v[tris[:, 0]], v[tris[:, 2]] - v[tris[:, 0]])
    vn = np.zeros_like(v)
    for k in range(3):
        np.add.at(vn, tris[:, k], fn)
    return vn / np.linalg.norm(vn, axis=1, keepdims=True)


def normals_checksum(normals: np.ndarray) -> float:
    """A sum over an (N, 3) array that moves with any entry and not with
    rounding: holds two copies of a normals routine to one function."""
    return float(np.abs(np.asarray(normals, np.float64) @ np.array([1.0, 2.0, 3.0])).sum())


def connected_components_vertices(mesh: Mesh) -> np.ndarray:
    """Label vertices by connected component of the vertex-edge graph
    (reference: DFS at signed_heat_tet_solver.cpp:183-210). Returns (V,)
    int labels, ordered by first-seen vertex index."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    e = mesh_edges(mesh)
    V = mesh.n_vertices
    adj = coo_matrix((np.ones(len(e)), (e[:, 0], e[:, 1])), shape=(V, V))
    _, labels = connected_components(adj, directed=False)
    return _relabel_first_seen(labels)


def connected_components_faces(mesh: Mesh) -> np.ndarray:
    """Label faces by component of the face-adjacency (shared-edge) graph
    (reference: DFS over adjacentFaces at signed_heat_tet_solver.cpp:257-285)."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    # Build edge -> faces map.
    F, D = mesh.faces.shape
    edge_keys = {}
    rows, cols = [], []
    for f in range(F):
        d = int(mesh.degrees[f])
        for s in range(d):
            a, b = int(mesh.faces[f, s]), int(mesh.faces[f, (s + 1) % d])
            key = (min(a, b), max(a, b))
            if key in edge_keys:
                g = edge_keys[key]
                rows.append(g)
                cols.append(f)
            else:
                edge_keys[key] = f
    adj = coo_matrix((np.ones(len(rows)), (rows, cols)), shape=(F, F))
    _, labels = connected_components(adj, directed=False)
    return _relabel_first_seen(labels)


def _relabel_first_seen(labels: np.ndarray) -> np.ndarray:
    out = np.empty_like(labels)
    mapping = {}
    for i, l in enumerate(labels):
        if l not in mapping:
            mapping[l] = len(mapping)
        out[i] = mapping[l]
    return out
