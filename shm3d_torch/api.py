"""Top-level API: ``SignedHeatSolver`` facade (port of shm3d.api).

Only the grid domain is ported so far; the tet domain raises."""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np

from shm3d.config import SignedHeatOptions
from shm3d.io.mesh_io import Mesh, PointCloud


class SignedHeatSolver:
    """domain: "tet" (the reference's default) or "grid".  ``device``:
    "cuda" (default) or "cpu"; "cuda" without a card raises."""

    def __init__(self, domain: str = "tet", device="cuda"):
        if domain not in ("tet", "grid"):
            raise ValueError(f"domain must be 'tet' or 'grid', got {domain!r}")
        if domain == "tet":
            raise NotImplementedError(
                "the tet domain is not ported yet (ROADMAP A14-A15); use "
                "domain='grid'")
        from .solvers.grid import GridSolver

        self.domain = domain
        self._impl = GridSolver(device=device)

    def compute_distance(self, geom: Union[Mesh, PointCloud],
                         options: SignedHeatOptions = SignedHeatOptions()):
        """A GridResult: phi per grid node."""
        return self._impl.compute_distance(geom, options)

    @property
    def last_stats(self) -> dict:
        """Diagnostics of the most recent solve (step3_path, iters, rel_res,
        phases, tform_eps, shell_nodes, mem_peak_mb on CUDA)."""
        return self._impl.last_stats

    def isosurface(self, result, isoval: float = 0.0) -> Tuple[np.ndarray, np.ndarray]:
        """Isosurface mesh (V, F) of a solve result (marching tets on the
        host, shared with shm3d)."""
        from shm3d.ops import contour

        return contour.grid_isosurface(result.grid, result.phi, isoval)
