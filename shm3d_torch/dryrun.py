"""Multi-device dry run of the port (counterpart of the JAX package's
``__graft_entry__.dryrun_multichip``):

    python -m shm3d_torch.dryrun --devices N [--device cpu]

On a 1-D mesh of the first N devices of ``--device``'s type (N CPU shards
with ``--device cpu``):

- one sharded grid solve through ``GridSolver(mesh=)`` at the smallest
  ``h_coef`` whose grid splits evenly over them;
- one tet solve through ``SignedHeatTetSolver(mesh=)`` (float32, ring Step 1,
  Step 3's operators split by rows), phi finite.

For an even N >= 4 both solves run again on a 2-D mesh of 2 slices, and each
phi must equal the 1-D mesh's bit for bit: the ring merges in the sources'
home order, the grid's Step 3 sees the same slabs and the tet domain's the
same row blocks.  Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def dryrun(n_devices: int, device: str = "cuda") -> dict:
    from .config import SignedHeatOptions
    from .geometry.procedural import make_icosphere
    from .parallel import device_mesh
    from .solvers.grid import GridSolver
    from .tet.solver import SignedHeatTetSolver

    mesh = device_mesh(n_devices, device=device)
    geom = make_icosphere(1)
    # the smallest hCoef whose grid (n = 16 * 2^h planes) splits evenly
    h = 0
    while (16 * 2 ** h) % n_devices and h < 5:
        h += 1
    options = SignedHeatOptions(dtype="float32", refine_steps=0, h_coef=float(h),
                                solver_maxiter=60, disk_cache=False)
    solver = GridSolver(mesh=mesh)
    phi = solver.compute_distance(geom, options).phi
    n = 16 * 2 ** h
    if phi.shape != (n ** 3,) or not np.isfinite(phi).all():
        raise RuntimeError(f"dry run: phi of shape {phi.shape}, finite "
                           f"{bool(np.isfinite(phi).all())}")
    stats = solver.last_stats
    summary = {"devices": n_devices, "device": device, "grid_n": n,
               "mesh": stats["mesh"], "iters": stats.get("iters")}

    tet_options = SignedHeatOptions(dtype="float32", refine_steps=0, solver_maxiter=60,
                                    disk_cache=False)
    tsolver = SignedHeatTetSolver(mesh=mesh)
    tphi = tsolver.compute_distance(geom, tet_options).phi
    if not np.isfinite(tphi).all():
        raise RuntimeError("dry run: the tet solve's phi is not finite")
    summary["tet"] = {"vertices": int(tphi.shape[0]),
                      "step3_path": tsolver.last_stats["step3_path"],
                      "iters": tsolver.last_stats.get("iters"),
                      "mesh": tsolver.last_stats["mesh"]}
    if n_devices % 2 == 0 and n_devices >= 4:
        mesh2d = device_mesh(n_devices, n_slices=2, device=device)
        phi2 = GridSolver(mesh=mesh2d).compute_distance(geom, options).phi
        if not np.array_equal(phi2, phi):
            raise RuntimeError("dry run: the 2-D mesh's phi differs from the 1-D mesh's")
        tphi2 = SignedHeatTetSolver(mesh=mesh2d).compute_distance(geom, tet_options).phi
        if not np.array_equal(tphi2, tphi):
            raise RuntimeError("dry run: the 2-D mesh's tet phi differs from the 1-D mesh's")
        summary["mesh2d_equal"] = True
    return summary


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m shm3d_torch.dryrun", description=__doc__.split("\n\n")[0])
    p.add_argument("--devices", type=int, required=True, metavar="N")
    p.add_argument("--device", default="cuda", help="device type of the mesh: cuda or cpu")
    args = p.parse_args(argv)
    print(json.dumps(dryrun(args.devices, args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
