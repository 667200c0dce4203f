"""Top-level API: ``SignedHeatSolver`` facade (port of shm3d.api)."""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np

from .config import SignedHeatOptions
from .io.mesh_io import Mesh, PointCloud


class SignedHeatSolver:
    """domain: "tet" (the reference's default) or "grid".  ``device``:
    "cuda" (default) or "cpu"; "cuda" without a card raises.

    The tet domain takes triangle meshes (Crouzeix-Raviart face solve on the
    conforming tet mesh by default; the vertex path with
    ``use_crouzeix_raviart=False`` or where the mesh does not conform),
    polygon meshes and oriented point clouds (vertex path), and
    ``fast_integration=True`` (greedy BFS on the host).

    ``mesh``: a device mesh (shm3d_torch.parallel.device_mesh, 1-D or 2-D)
    for a multi-device solve of either domain; the solve then runs on the
    mesh's devices and ``device`` defaults to its first one (the tet domain
    refuses another)."""

    def __init__(self, domain: str = "tet", device=None, mesh=None):
        if domain not in ("tet", "grid"):
            raise ValueError(f"domain must be 'tet' or 'grid', got {domain!r}")
        self.domain = domain
        if domain == "tet":
            from .tet.solver import SignedHeatTetSolver

            self._impl = SignedHeatTetSolver(device=device, mesh=mesh)
        else:
            from .solvers.grid import GridSolver

            self._impl = GridSolver(device="cuda" if device is None else device, mesh=mesh)

    def compute_distance(self, geom: Union[Mesh, PointCloud],
                         options: SignedHeatOptions = SignedHeatOptions()):
        """A GridResult (phi per grid node) or a TetResult (phi per tet
        vertex)."""
        return self._impl.compute_distance(geom, options)

    @property
    def last_stats(self) -> dict:
        """Diagnostics of the most recent solve (step3_path, iterations,
        residuals, phases, mem_peak_mb on CUDA)."""
        return self._impl.last_stats

    def isosurface(self, result, isoval: float = 0.0) -> Tuple[np.ndarray, np.ndarray]:
        """Isosurface mesh (V, F) of a solve result, extracted on the host
        by marching tets (``shm3d_torch.ops.contour``)."""
        from .ops import contour

        if self.domain == "grid":
            return contour.grid_isosurface(result.grid, result.phi, isoval)
        return contour.marching_tets(result.mesh.vertices, result.mesh.tets,
                                     result.phi, isoval)
