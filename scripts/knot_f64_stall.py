#!/usr/bin/env python3
"""Where the float64 Crouzeix-Raviart face solve of knot_dec stops, on the
card: at the library's options (the AMG-CG's float64 stall window, 1,000
iterations without a 2% gain, as in shm3d.tet.solver._stall_window) and
with the window opened past ``solver_maxiter``.

    python3 scripts/knot_f64_stall.py [--maxiter N]

For each run prints the face iterations, the final face residual (the
preconditioned CG's, relative), the projection's, the wall time and phi's
min / max / mean |phi| / mean |phi| at the sources against the JAX
package's float32 numbers on the same input (chip_smoke.py's constants),
and the rel-L2 between the two runs' phi.  Needs an NVIDIA GPU; ~3 min."""

import argparse
import os
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

KNOT = os.path.join(REPO, "tests", "data", "knot_dec.obj")
# the JAX package's float32 solve of knot_dec (chip_smoke.py, JAX_PHI_*)
JAX_PHI = dict(min=-25.49828, max=145.07733, mean_abs=55.45258, src_mean_abs=0.74078)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--maxiter", type=int, default=12000,
                    help="solver_maxiter of the run without the stall window")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("knot_f64_stall: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import subprocess

    from shm3d_torch import SignedHeatOptions, SignedHeatSolver
    from shm3d_torch.io.mesh_io import read_geometry
    from shm3d_torch.tet import solver as tet_solver

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"gpu: {smi}")
    geom = read_geometry(KNOT)
    solver = SignedHeatSolver("tet", device="cuda")
    window = tet_solver._stall_window
    phis = {}
    for name, opts, stall in (
            ("stall window 1000 (the library's)", SignedHeatOptions(dtype="float64",
                                                                  disk_cache=False), None),
            (f"no stall window, solver_maxiter {args.maxiter}",
             SignedHeatOptions(dtype="float64", disk_cache=False, solver_maxiter=args.maxiter),
             args.maxiter + 1)):
        if stall is not None:
            tet_solver._stall_window = lambda dtype: stall
        try:
            t0 = time.perf_counter()
            res = solver.compute_distance(geom, opts)
            torch.cuda.synchronize()
            s = time.perf_counter() - t0
        finally:
            tet_solver._stall_window = window
        st = solver.last_stats
        phi = res.phi
        got = dict(min=float(phi.min()), max=float(phi.max()), mean_abs=float(np.abs(phi).mean()),
                   src_mean_abs=float(np.abs(res.phi_at_sources()).mean()))
        off = ", ".join(f"{k} {got[k]:.6f} (off {abs(got[k] - v) / abs(v):.3e})"
                        for k, v in JAX_PHI.items())
        print(f"{name}: {s:.3f} s, face iters {st['iters']}, final face residual "
              f"{st['residual']:.4e}, projection {st['proj_iters']} iters "
              f"{st['proj_residual']:.4e}, Step 3 "
              f"{st['phases'].get('step 3 (Crouzeix-Raviart face solve)', 0):.3f} s; phi {off} "
              f"({smi})", flush=True)
        phis[name] = phi
    a, b = phis.values()
    print(f"rel-L2 between the two runs' phi {np.linalg.norm(a - b) / np.linalg.norm(b):.4e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
