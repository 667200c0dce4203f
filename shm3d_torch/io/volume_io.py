"""Headless volume export (copied from shm3d/io/volume_io.py).

The reference visualizes volumes exclusively through Polyscope
(registerVolumeGrid / registerTetMesh + slice planes,
/root/reference/src/main.cpp:82-111).  Headless equivalents:

- ``write_vtk_grid``: legacy-VTK STRUCTURED_POINTS file of a grid node
  field (opens in ParaView/VisIt);
- ``write_vtk_tet``: legacy-VTK UNSTRUCTURED_GRID of a tet mesh with a
  per-vertex scalar;
- ``.npy`` export is plain ``numpy.save`` (see shm3d_torch.cli --export-phi).
"""

from __future__ import annotations

import numpy as np


def write_vtk_grid(path: str, grid, phi_flat: np.ndarray, name: str = "phi") -> None:
    """grid: shm3d_torch.domains.grid.GridSpec; phi_flat in reference node order
    (i + j*n + k*n^2 == x fastest, exactly VTK's point ordering)."""
    n = grid.n
    phi = np.asarray(phi_flat, dtype=np.float64).reshape(-1)
    with open(path, "w") as fh:
        fh.write("# vtk DataFile Version 3.0\nshm3d signed distance\nASCII\n")
        fh.write("DATASET STRUCTURED_POINTS\n")
        fh.write(f"DIMENSIONS {n} {n} {n}\n")
        fh.write(f"ORIGIN {grid.bbox_min[0]} {grid.bbox_min[1]} {grid.bbox_min[2]}\n")
        fh.write(f"SPACING {grid.cell_size} {grid.cell_size} {grid.cell_size}\n")
        fh.write(f"POINT_DATA {phi.shape[0]}\n")
        fh.write(f"SCALARS {name} double 1\nLOOKUP_TABLE default\n")
        np.savetxt(fh, phi, fmt="%.9g")


def write_vtk_tet(path: str, vertices: np.ndarray, tets: np.ndarray,
                  phi: np.ndarray, name: str = "phi") -> None:
    vertices = np.asarray(vertices, dtype=np.float64)
    tets = np.asarray(tets, dtype=np.int64)
    phi = np.asarray(phi, dtype=np.float64)
    nv, nt = vertices.shape[0], tets.shape[0]
    with open(path, "w") as fh:
        fh.write("# vtk DataFile Version 3.0\nshm3d tet domain\nASCII\n")
        fh.write("DATASET UNSTRUCTURED_GRID\n")
        fh.write(f"POINTS {nv} double\n")
        np.savetxt(fh, vertices, fmt="%.9g")
        fh.write(f"CELLS {nt} {5 * nt}\n")
        cells = np.column_stack([np.full(nt, 4, dtype=np.int64), tets])
        np.savetxt(fh, cells, fmt="%d")
        fh.write(f"CELL_TYPES {nt}\n")
        np.savetxt(fh, np.full(nt, 10, dtype=np.int64), fmt="%d")  # VTK_TETRA
        fh.write(f"POINT_DATA {nv}\n")
        fh.write(f"SCALARS {name} double 1\nLOOKUP_TABLE default\n")
        np.savetxt(fh, phi, fmt="%.9g")
