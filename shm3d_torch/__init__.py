"""shm3d_torch: the PyTorch / CUDA port of shm3d.

The same Signed Heat Method pipeline as ``shm3d`` (the JAX reference
package), in PyTorch, with the Pallas TPU kernels rewritten by hand for
NVIDIA Hopper (``shm3d_torch/csrc``).  The port imports neither JAX nor
``shm3d``: it keeps its own copies of the host modules it needs (options,
geometry I/O, source quadrature, grid construction, the tet mesher with its
native core, FEM assembly, orderings, the artifact stores, contouring) under
the same relative paths.  Its entry points take only its own option and
geometry types.  The options and the procedural fixtures are re-exported
here.
"""

from .config import LevelSetConstraint, SignedHeatOptions
from .geometry.procedural import make_icosphere, make_sphere_cloud

from .api import SignedHeatSolver

__version__ = "0.1.0"
__all__ = [
    "LevelSetConstraint",
    "SignedHeatOptions",
    "SignedHeatSolver",
    "make_icosphere",
    "make_sphere_cloud",
]
