"""Optional interactive viewer: the polyscope adapter (copied from
shm3d/io/viewer.py).

The reference is an interactive app (/root/reference/src/main.cpp:130-294):
it registers the input surface/point cloud and the solve domain with
polyscope, re-solves on button clicks with slider-adjusted options
(tCoef, hCoef, constraint mode, CR toggle — main.cpp:131-160), shows the
signed distance as an isoline-shaded scalar quantity behind a scene slice
plane (main.cpp:82-108), and contours/export the zero level set on demand
(main.cpp:117-128, :163-191).

It is gated on the *optional* ``polyscope`` dependency (``pip install
polyscope`` on a workstation; without it everything here degrades to a
clear error pointing at the headless exports
``--export-iso/--export-phi/--export-vtk``).  Nothing in
the core package imports this module; the CLI reaches it only under
``--view``.
"""

from __future__ import annotations

import sys
from typing import Optional

import numpy as np

from ..config import LevelSetConstraint, SignedHeatOptions


def polyscope_available() -> bool:
    try:
        import polyscope  # noqa: F401

        return True
    except ImportError:
        return False


def _require_polyscope():
    try:
        import polyscope as ps
        import polyscope.imgui as psim

        return ps, psim
    except ImportError as e:
        raise RuntimeError(
            "Interactive viewing needs the optional 'polyscope' package "
            "(pip install polyscope), which is not installed. Headless "
            "alternatives: --export-iso iso.obj (zero level set), "
            "--export-vtk vol.vtk (ParaView volume), --export-phi phi.npy."
        ) from e


class Viewer:
    """Interactive solve-and-inspect loop, mirroring the reference GUI.

    Parameters mirror ``shm3d_torch.cli``: a loaded geometry, a configured
    ``SignedHeatSolver`` facade, and initial options.  ``launch()`` blocks
    inside ``polyscope.show()``.
    """

    def __init__(self, geom, solver, options: SignedHeatOptions,
                 input_name: str = "input"):
        self.geom = geom
        self.solver = solver
        self.options = options
        self.input_name = input_name
        self.result = None
        self.isoval = 0.0
        self._last_solve_s = None
        # mutable copies of the slider-driven option fields
        # (reference: TCOEF/HCOEF/CONSTRAINT_MODE globals, main.cpp:131-160)
        self._t_coef = float(options.t_coef)
        self._h_coef = float(options.h_coef)
        self._constraint = options.level_set_constraint
        self._use_cr = bool(options.use_crouzeix_raviart)
        self._fast = bool(options.fast_integration)

    # -- registration ------------------------------------------------------

    def _register_input(self, ps):
        if hasattr(self.geom, "faces") and getattr(self.geom, "faces", None) is not None:
            F = self.geom.faces
            # padded polygon rows (−1 fill) are accepted by polyscope as
            # nested lists
            if (np.asarray(F) < 0).any():
                F = [[v for v in row if v >= 0] for row in np.asarray(F)]
            ps.register_surface_mesh(self.input_name, self.geom.vertices, F)
        else:
            ps.register_point_cloud(self.input_name, self.geom.positions)

    def _register_domain(self, ps):
        """Volume grid (grid domain) or volume mesh (tet domain) with the
        solved scalar, viridis + isolines, like main.cpp:82-101."""
        res = self.result
        phi = np.asarray(res.phi, dtype=np.float64)
        if self.solver.domain == "grid":
            g = res.grid
            lo = np.asarray(g.bbox_min, dtype=np.float64)
            hi = lo + (g.n - 1) * g.cell_size
            vg = ps.register_volume_grid("domain", (g.n, g.n, g.n), lo, hi)
            # flat index is i + j*n + k*n^2 == C-order [k, j, i]; polyscope
            # wants Fortran-order (i fastest) on the (nx, ny, nz) dims —
            # which is exactly the flat order, reshaped F-style.
            q = vg.add_scalar_quantity(
                "GSD", phi.reshape(g.n, g.n, g.n, order="F"),
                defined_on="nodes", enabled=True,
            )
        else:
            vm = ps.register_volume_mesh(
                "domain", np.asarray(res.mesh.vertices),
                tets=np.asarray(res.mesh.tets))
            vm.set_cull_whole_elements(True)
            q = vm.add_vertex_scalar_quantity("GSD", phi, enabled=True)
        try:
            q.set_color_map("viridis")
            q.set_isolines_enabled(True)
        except AttributeError:
            pass  # older polyscope builds; scalar display still works
        return q

    def _add_slice_plane(self, ps):
        # main.cpp:102-110: one scene slice plane, input excluded from it
        for attr in ("remove_last_scene_slice_plane",):
            if hasattr(ps, attr):
                try:
                    getattr(ps, attr)()
                except Exception:
                    pass
        plane = ps.add_scene_slice_plane()
        plane.set_draw_plane(False)
        plane.set_draw_widget(True)
        try:
            ps.get_surface_mesh(self.input_name).set_ignore_slice_plane(plane, True)
        except Exception:
            try:
                ps.get_point_cloud(self.input_name).set_ignore_slice_plane(plane, True)
            except Exception:
                pass
        return plane

    # -- actions ------------------------------------------------------------

    def solve(self, ps):
        import time

        self.options = self.options.with_(
            t_coef=self._t_coef, h_coef=self._h_coef,
            level_set_constraint=self._constraint,
            use_crouzeix_raviart=self._use_cr,
            fast_integration=self._fast,
        )
        t0 = time.time()
        self.result = self.solver.compute_distance(self.geom, self.options)
        self._last_solve_s = time.time() - t0
        phi = self.result.phi
        print(f"Solve time (s): {self._last_solve_s:.3f}", file=sys.stderr)
        print(f"min: {phi.min():.6g}\tmax: {phi.max():.6g}", file=sys.stderr)
        self._register_domain(ps)
        self._add_slice_plane(ps)

    def contour(self, ps):
        # both domains route through the product isosurface (marching tets /
        # grid Kuhn-cell contouring), reference main.cpp:117-128
        V, F = self.solver.isosurface(self.result, self.isoval)
        m = ps.register_surface_mesh("isosurface", V, F)
        return m

    def export_isosurface(self, path: str = "isosurface.obj"):
        from .mesh_io import write_obj

        V, F = self.solver.isosurface(self.result, self.isoval)
        write_obj(path, V, F)
        print(f"Isosurface written to {path}", file=sys.stderr)

    # -- UI callback ---------------------------------------------------------

    def _callback(self, ps, psim):
        # layout mirrors the reference callback (main.cpp:130-194)
        changed, self._t_coef = psim.InputFloat("tCoef", self._t_coef)
        changed, self._h_coef = psim.InputFloat("hCoef", self._h_coef)
        modes = ["ZeroSet", "Multiple", "None"]
        cur = {LevelSetConstraint.ZERO_SET: 0, LevelSetConstraint.MULTIPLE: 1,
               LevelSetConstraint.NONE: 2}[self._constraint]
        changed, cur = psim.Combo("level set constraint", cur, modes)
        self._constraint = [LevelSetConstraint.ZERO_SET,
                            LevelSetConstraint.MULTIPLE,
                            LevelSetConstraint.NONE][cur]
        if self.solver.domain == "tet":
            _, self._use_cr = psim.Checkbox("Crouzeix-Raviart", self._use_cr)
        _, self._fast = psim.Checkbox("fast (greedy) integration", self._fast)
        if psim.Button("Solve"):
            self.solve(ps)
        if self.result is not None:
            _, self.isoval = psim.InputFloat("isovalue", self.isoval)
            if psim.Button("Contour"):
                self.contour(ps)
            if psim.Button("Export isosurface"):
                self.export_isosurface()

    def launch(self, solve_first: bool = True):
        ps, psim = _require_polyscope()
        ps.init()
        self._register_input(ps)
        if solve_first:
            self.solve(ps)
        ps.set_user_callback(lambda: self._callback(ps, psim))
        ps.show()


def launch_viewer(geom, solver, options: SignedHeatOptions,
                  input_name: str = "input",
                  solve_first: bool = True) -> Optional[Viewer]:
    """CLI entry point for ``--view``.  Raises RuntimeError (with the
    headless alternatives) when polyscope is not installed."""
    v = Viewer(geom, solver, options, input_name=input_name)
    v.launch(solve_first=solve_first)
    return v
