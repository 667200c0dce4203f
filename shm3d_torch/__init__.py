"""shm3d_torch: the PyTorch / CUDA port of shm3d.

The same Signed Heat Method pipeline as ``shm3d`` (the JAX reference
package), in PyTorch, with the Pallas TPU kernels rewritten by hand for
NVIDIA Hopper (``shm3d_torch/csrc``).  The port never imports JAX; it shares
the JAX-free host modules of ``shm3d`` (options, geometry I/O, source
quadrature, grid construction, the tet mesher and FEM assembly); the
options and the procedural fixtures are re-exported here.
"""

from shm3d.config import LevelSetConstraint, SignedHeatOptions
from shm3d.geometry.procedural import make_icosphere, make_sphere_cloud

from .api import SignedHeatSolver

__version__ = "0.1.0"
__all__ = [
    "LevelSetConstraint",
    "SignedHeatOptions",
    "SignedHeatSolver",
    "make_icosphere",
    "make_sphere_cloud",
]
