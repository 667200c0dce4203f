"""Headless CLI of the port, with shm3d.cli's flags and ``--device``.

    python -m shm3d_torch.cli mesh.obj --grid --h 1 --export-iso iso.obj --export-phi phi.npy

The reference binary accepts ``--g/--grid``, ``--f/--fast``,
``--V/--verbose`` and opens a Polyscope GUI; this CLI keeps those flags,
implements ``--h`` (hCoef), and adds headless outputs.  It solves on
``--device`` (default ``cuda``; ``cuda`` without a card fails, nothing
falls back to the CPU).  ``--devices N`` (with ``--slices K``) solves
either domain on a mesh of the first N devices of ``--device``'s type (N CPU
shards with ``--device cpu``); ``--json`` then reports the mesh.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from .api import SignedHeatSolver
from .config import LevelSetConstraint, SignedHeatOptions
from .io.mesh_io import read_geometry, write_obj


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="shm3d-torch",
        description="Generalized signed distance in 3D via the signed heat method "
        "(the PyTorch / CUDA port of shm3d). The grid solve's V-cycle always "
        "uses pin masks (shm3d's SHM3D_PIN_MG switch is not ported).",
    )
    p.add_argument("input", help="mesh (.obj/.ply/.off/.stl) or oriented point cloud (.pc)")
    p.add_argument("--g", "--grid", dest="grid", action="store_true",
                   help="solve on a background grid (default: tet mesh)")
    p.add_argument("--f", "--fast", dest="fast", action="store_true",
                   help="greedy (BFS) integration instead of the Poisson solve")
    p.add_argument("--V", "--verbose", dest="verbose", action="store_true",
                   help="per-phase timing to stderr")
    p.add_argument("--h", dest="h_coef", type=float, default=0.0,
                   help="mesh refinement exponent hCoef (grid: n = 2*2^(h+3))")
    p.add_argument("--t-coef", type=float, default=1.0, help="diffusion time factor tCoef")
    p.add_argument("--scale", type=float, default=2.0, help="bounding-cube half-side = radius*scale")
    p.add_argument("--constraint", choices=["zero", "multiple", "none"], default="zero",
                   help="level-set constraint mode (tet domain; the grid domain "
                        "always soft-pins the zero set, like the reference)")
    p.add_argument("--no-cr", dest="use_cr", action="store_false",
                   help="tet domain: integrate on vertices (P1) instead of the "
                        "default Crouzeix-Raviart face elements (reference GUI "
                        "toggle, main.cpp:142-144)")
    p.add_argument("--dtype", choices=["float32", "float64"], default="float32")
    p.add_argument("--tol", type=float, default=None,
                   help="iterative solver tolerance (default: dtype-aware, "
                        "1e-5 for float32 / 1e-10 for float64)")
    p.add_argument("--step1", choices=["auto", "dense", "shell"], default="auto",
                   help="grid Step-1 strategy: dense pairwise kernel, the "
                        "shell decomposition (exact near surface + coarse-"
                        "interpolated far field), or auto (shell at >=128^3)")
    p.add_argument("--device", default="cuda",
                   help="torch device to solve on: cuda (default) or cpu")
    p.add_argument("--devices", type=int, default=0, metavar="N",
                   help="solve on a mesh of the first N devices of --device's "
                        "type (N CPU shards with --device cpu): on the grid the "
                        "Step-1 kernel split over them and Step 3 on z-slabs, on "
                        "the tet domain Step 1 on the ring and Step 3's operators "
                        "split by rows; 0 = single device")
    p.add_argument("--slices", type=int, default=1, metavar="K",
                   help="with --devices N: a 2-D mesh of K slices of N/K devices "
                        "(the hierarchical ring for a ring Step 1)")
    p.add_argument("--no-disk-cache", action="store_true",
                   help="disable the cross-process operator cache "
                        "($SHM3D_CACHE_DIR)")
    p.add_argument("--export-iso", metavar="PATH", help="write the zero isosurface as OBJ")
    p.add_argument("--isoval", type=float, default=0.0, help="isovalue for --export-iso")
    p.add_argument("--export-phi", metavar="PATH", help="write phi as .npy")
    p.add_argument("--export-vtk", metavar="PATH",
                   help="write the solved volume as legacy VTK (ParaView)")
    p.add_argument("--view", action="store_true",
                   help="interactive polyscope viewer (optional dependency; "
                        "the reference app's GUI, main.cpp:130-294). Solves "
                        "once, then re-solve/contour/export from the UI")
    p.add_argument("--json", action="store_true", help="print a JSON summary line")
    p.add_argument("--profile", metavar="LOGDIR",
                   help="write a torch.profiler trace of the solve to "
                        "LOGDIR/trace.json (chrome://tracing or Perfetto)")
    p.add_argument("--debug", action="store_true",
                   help="numerical sanitizer: validate solver invariants at "
                        "phase boundaries (finite fields, unit Step-2 rows, "
                        "operator symmetry, constraint satisfaction); also "
                        "enabled by SHM3D_DEBUG=1")
    return p


_CONSTRAINTS = {
    "zero": LevelSetConstraint.ZERO_SET,
    "multiple": LevelSetConstraint.MULTIPLE,
    "none": LevelSetConstraint.NONE,
}


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.slices != 1 and not args.devices:
        raise ValueError("--slices needs --devices")
    if args.debug:
        from .utils import checks

        checks.enable()
    geom = read_geometry(args.input)

    options = SignedHeatOptions(
        level_set_constraint=_CONSTRAINTS[args.constraint],
        t_coef=args.t_coef,
        h_coef=args.h_coef,
        scale=args.scale,
        use_crouzeix_raviart=args.use_cr,
        fast_integration=args.fast,
        dtype=args.dtype,
        solver_tol=args.tol,
        step1_method=args.step1,
        disk_cache=not args.no_disk_cache,
        verbose=args.verbose,
    )
    mesh = None
    if args.devices:
        from .parallel import device_mesh

        mesh = device_mesh(args.devices, n_slices=args.slices, device=args.device)
    solver = SignedHeatSolver("grid" if args.grid else "tet", device=args.device,
                              mesh=mesh)

    if args.view:
        from .io.viewer import launch_viewer

        try:
            launch_viewer(geom, solver, options, input_name=args.input)
        except RuntimeError as e:
            print(f"shm3d-torch: {e}", file=sys.stderr)
            return 2
        return 0

    from .utils.timing import profiler_trace

    t0 = time.time()
    with profiler_trace(args.profile):
        result = solver.compute_distance(geom, options)
    solve_s = time.time() - t0
    phi = result.phi
    if args.verbose:
        print(f"Solve time (s): {solve_s:.3f}", file=sys.stderr)
        print(f"min/max of phi: {phi.min():.6g} / {phi.max():.6g}", file=sys.stderr)

    if args.export_phi:
        np.save(args.export_phi, phi)
    if args.export_vtk:
        from .io import volume_io

        if args.grid:
            volume_io.write_vtk_grid(args.export_vtk, result.grid, phi)
        else:
            volume_io.write_vtk_tet(args.export_vtk, result.mesh.vertices,
                                    result.mesh.tets, phi)
    if args.export_iso:
        V, F = solver.isosurface(result, args.isoval)
        write_obj(args.export_iso, V, F)
        if args.verbose:
            print(f"isosurface: {V.shape[0]} vertices / {F.shape[0]} faces -> "
                  f"{args.export_iso}", file=sys.stderr)

    if args.json:
        print(json.dumps({
            "input": args.input,
            "domain": solver.domain,
            "device": args.device,
            "solve_s": round(solve_s, 4),
            "phi_min": float(phi.min()),
            "phi_max": float(phi.max()),
            "n_unknowns": int(phi.shape[0]),
            # e.g. the >32^3 --f greedy path runs the device wavefront, not
            # the reference BFS
            "step3_path": solver.last_stats.get("step3_path"),
            "tier": solver.last_stats.get("tier"),
            "mesh": solver.last_stats.get("mesh"),
        }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
