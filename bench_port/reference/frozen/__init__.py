"""Frozen copies of the JAX-free host code the grid reference needs.

These are copies, taken when the benchmark was written, of the port's host
modules ``geometry/pointcloud.py``, ``geometry/surface.py``,
``io/mesh_io.py`` and ``domains/grid.py``, and of the shell plan of
``ops/farfield.py``, with only their imports redirected here.  The grid
reference derives the discretization again from the benchmark's own inputs
with them: the point cloud's quadrature, the grid, its constraint rows and
the shell plan.  They are never edited, so a later change to the port's
host code is judged against what the inputs need, not against itself.
"""
