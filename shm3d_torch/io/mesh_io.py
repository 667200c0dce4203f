"""Host-side mesh / point-cloud IO.

Replaces geometry-central's ``readSurfaceMesh`` / ``writeSurfaceMesh``
(reference src/main.cpp:269,189) and the custom ``.pc`` reader
(reference src/main.cpp:196-225).  Formats: .obj / .off / .ply / .stl
for surfaces, .pc ("v x y z" + "vn x y z" lines) for oriented point clouds.

Meshes are returned as a ``Mesh`` of float64 vertex positions plus a padded
face-index array so polygon meshes (e.g. data/polygon-bear.obj, faces of
degree 3-11) ride the same array contract as triangle meshes.
"""

from __future__ import annotations

import dataclasses
import os
import struct
from typing import List, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class Mesh:
    """A polygonal surface mesh.

    vertices: (V, 3) float64.
    faces:    (F, D) int64, padded with -1 past each face's degree.
    degrees:  (F,) int64, number of vertices of each face.
    """

    vertices: np.ndarray
    faces: np.ndarray
    degrees: np.ndarray

    @property
    def n_vertices(self) -> int:
        return int(self.vertices.shape[0])

    @property
    def n_faces(self) -> int:
        return int(self.faces.shape[0])

    @property
    def is_triangular(self) -> bool:
        return bool(np.all(self.degrees == 3))

    def triangles(self) -> np.ndarray:
        """(F, 3) triangle index array; raises if not triangular."""
        if not self.is_triangular:
            raise ValueError("mesh is not triangular")
        return np.ascontiguousarray(self.faces[:, :3])

    @staticmethod
    def from_face_lists(vertices: np.ndarray, face_lists: Sequence[Sequence[int]]) -> "Mesh":
        degrees = np.array([len(f) for f in face_lists], dtype=np.int64)
        max_deg = int(degrees.max()) if len(face_lists) else 3
        faces = np.full((len(face_lists), max_deg), -1, dtype=np.int64)
        for i, f in enumerate(face_lists):
            faces[i, : len(f)] = f
        return Mesh(np.asarray(vertices, dtype=np.float64).reshape(-1, 3), faces, degrees)


@dataclasses.dataclass
class PointCloud:
    """An oriented point cloud: positions + unit normals, both (P, 3) float64."""

    positions: np.ndarray
    normals: np.ndarray

    @property
    def n_points(self) -> int:
        return int(self.positions.shape[0])


# ---------------------------------------------------------------------------
# readers


def _parse_index(tok: str, n_vertices: int) -> int:
    # OBJ face tokens may be "v", "v/vt", "v//vn", "v/vt/vn"; 1-based, negatives
    # count from the end.
    idx = int(tok.split("/")[0])
    return idx - 1 if idx > 0 else n_vertices + idx


def read_obj(path: str) -> Mesh:
    vertices: List[Tuple[float, float, float]] = []
    face_lists: List[List[int]] = []
    with open(path, "r") as fh:
        for line in fh:
            if not line or line[0] not in "vf":
                continue
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                vertices.append((float(parts[1]), float(parts[2]), float(parts[3])))
            elif parts[0] == "f":
                nv = len(vertices)
                face_lists.append([_parse_index(t, nv) for t in parts[1:]])
    return Mesh.from_face_lists(np.array(vertices, dtype=np.float64), face_lists)


def read_off(path: str) -> Mesh:
    with open(path, "r") as fh:
        tokens: List[str] = []
        for line in fh:
            line = line.split("#")[0].strip()
            if line:
                tokens.extend(line.split())
    pos = 0
    if tokens[0].upper().endswith("OFF"):
        pos = 1
    nv, nf = int(tokens[pos]), int(tokens[pos + 1])
    pos += 3  # skip edge count
    verts = np.array(tokens[pos : pos + 3 * nv], dtype=np.float64).reshape(nv, 3)
    pos += 3 * nv
    face_lists = []
    for _ in range(nf):
        d = int(tokens[pos])
        face_lists.append([int(t) for t in tokens[pos + 1 : pos + 1 + d]])
        pos += 1 + d
    return Mesh.from_face_lists(verts, face_lists)


def read_ply(path: str) -> Mesh:
    with open(path, "rb") as fh:
        data = fh.read()
    header_end = data.find(b"end_header")
    if header_end < 0:
        raise ValueError(f"{path}: not a PLY file")
    header = data[:header_end].decode("ascii", errors="replace").splitlines()
    body = data[data.find(b"\n", header_end) + 1 :]

    fmt = "ascii"
    elements: List[Tuple[str, int, List[Tuple[str, str]]]] = []
    for line in header:
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property" and elements:
            if parts[1] == "list":
                elements[-1][2].append(("list:" + parts[2] + ":" + parts[3], parts[4]))
            else:
                elements[-1][2].append((parts[1], parts[2]))

    type_map = {
        "char": "b", "int8": "b", "uchar": "B", "uint8": "B",
        "short": "h", "int16": "h", "ushort": "H", "uint16": "H",
        "int": "i", "int32": "i", "uint": "I", "uint32": "I",
        "float": "f", "float32": "f", "double": "d", "float64": "d",
    }

    verts = None
    face_lists: List[List[int]] = []
    if fmt == "ascii":
        tokens = body.decode("ascii").split()
        pos = 0
        for name, count, props in elements:
            if name == "vertex":
                width = len(props)
                xi = [i for i, (t, n) in enumerate(props) if n in ("x", "y", "z")]
                arr = np.array(tokens[pos : pos + width * count], dtype=np.float64).reshape(count, width)
                verts = arr[:, xi]
                pos += width * count
            elif name == "face":
                for _ in range(count):
                    d = int(tokens[pos])
                    face_lists.append([int(t) for t in tokens[pos + 1 : pos + 1 + d]])
                    pos += 1 + d
            else:
                # skip unknown ascii elements conservatively (fixed props only)
                pos += len(props) * count
    else:
        endian = "<" if "little" in fmt else ">"
        off = 0
        for name, count, props in elements:
            if name == "vertex":
                fmt_str = endian + "".join(type_map[t] for t, _ in props)
                width = struct.calcsize(fmt_str)
                names = [n for _, n in props]
                xi = [names.index(c) for c in ("x", "y", "z")]
                rows = np.zeros((count, 3), dtype=np.float64)
                for i in range(count):
                    vals = struct.unpack_from(fmt_str, body, off + i * width)
                    rows[i] = [vals[xi[0]], vals[xi[1]], vals[xi[2]]]
                verts = rows
                off += width * count
            elif name == "face":
                t, n = props[0]
                _, count_t, idx_t = t.split(":")
                cfmt, ifmt = endian + type_map[count_t], type_map[idx_t]
                csz = struct.calcsize(cfmt)
                isz = struct.calcsize(endian + ifmt)
                for _ in range(count):
                    (d,) = struct.unpack_from(cfmt, body, off)
                    off += csz
                    face_lists.append(list(struct.unpack_from(endian + ifmt * d, body, off)))
                    off += isz * d
            else:
                fmt_str = endian + "".join(type_map[t] for t, _ in props if not t.startswith("list:"))
                off += struct.calcsize(fmt_str) * count
    if verts is None:
        raise ValueError(f"{path}: PLY file has no vertex element")
    return Mesh.from_face_lists(verts, face_lists)


def read_stl(path: str) -> Mesh:
    with open(path, "rb") as fh:
        data = fh.read()
    is_ascii = data[:5] == b"solid" and b"facet" in data[:1024]
    tris: List[np.ndarray] = []
    if is_ascii:
        tokens = data.decode("ascii", errors="replace").split()
        i = 0
        while i < len(tokens):
            if tokens[i] == "vertex":
                tris.append(np.array(tokens[i + 1 : i + 4], dtype=np.float64))
                i += 4
            else:
                i += 1
    else:
        (n,) = struct.unpack_from("<I", data, 80)
        for i in range(n):
            off = 84 + 50 * i + 12  # skip normal
            vals = struct.unpack_from("<9f", data, off)
            for j in range(3):
                tris.append(np.array(vals[3 * j : 3 * j + 3], dtype=np.float64))
    pts = np.array(tris, dtype=np.float64).reshape(-1, 3)
    # Weld identical vertices so the mesh has shared connectivity.
    uniq, inverse = np.unique(pts.round(decimals=12), axis=0, return_inverse=True)
    faces = inverse.reshape(-1, 3)
    return Mesh.from_face_lists(uniq, [list(f) for f in faces])


def read_pc(path: str) -> PointCloud:
    """Read a ``.pc`` oriented point cloud: "v x y z" and "vn x y z" lines
    (reference parser: reference src/main.cpp:196-225)."""
    positions: List[Tuple[float, float, float]] = []
    normals: List[Tuple[float, float, float]] = []
    with open(path, "r") as fh:
        for line in fh:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                positions.append((float(parts[1]), float(parts[2]), float(parts[3])))
            elif parts[0] == "vn":
                normals.append((float(parts[1]), float(parts[2]), float(parts[3])))
    if len(positions) != len(normals):
        raise ValueError(f"{path}: {len(positions)} positions but {len(normals)} normals")
    return PointCloud(np.array(positions, dtype=np.float64), np.array(normals, dtype=np.float64))


def read_surface(path: str) -> Mesh:
    ext = os.path.splitext(path)[1].lower()
    readers = {".obj": read_obj, ".off": read_off, ".ply": read_ply, ".stl": read_stl}
    if ext not in readers:
        raise ValueError(f"unsupported surface format: {ext}")
    return readers[ext](path)


def read_geometry(path: str):
    """Dispatch on extension like the reference CLI
    (reference src/main.cpp:267-288): ``.pc`` -> PointCloud, else Mesh."""
    if os.path.splitext(path)[1].lower() == ".pc":
        return read_pc(path)
    return read_surface(path)


# ---------------------------------------------------------------------------
# writers


def write_obj(path: str, vertices: np.ndarray, faces: np.ndarray, degrees=None) -> None:
    """Write an OBJ surface (isosurface export analog of
    reference src/main.cpp:188-190)."""
    vertices = np.asarray(vertices)
    faces = np.asarray(faces)
    with open(path, "w") as fh:
        for v in vertices:
            fh.write(f"v {v[0]:.17g} {v[1]:.17g} {v[2]:.17g}\n")
        for i, f in enumerate(faces):
            d = int(degrees[i]) if degrees is not None else len(f)
            idx = " ".join(str(int(j) + 1) for j in f[:d] if j >= 0)
            fh.write(f"f {idx}\n")


def write_pc(path: str, positions: np.ndarray, normals: np.ndarray) -> None:
    with open(path, "w") as fh:
        for p, n in zip(np.asarray(positions), np.asarray(normals)):
            fh.write(f"v {p[0]:.17g} {p[1]:.17g} {p[2]:.17g}\n")
            fh.write(f"vn {n[0]:.17g} {n[1]:.17g} {n[2]:.17g}\n")
