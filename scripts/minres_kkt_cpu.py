#!/usr/bin/env python3
"""The grid's MINRES-on-KKT Step 3 (solver_method="minres_kkt") in float32
against projected CG, the port beside the JAX package, both on the CPU, on
the main path's input (make_sphere_cloud(52290), shell Step 1) at 32^3 and
64^3.

    JAX_PLATFORMS=cpu python3 scripts/minres_kkt_cpu.py [H_COEF ...]

For each h_coef (default 1 2) prints, for each package: the MINRES
iterations and final phibar, phi's rel-L2 against the same package's
projected-CG fast tier and against |x| - 1, and the default tier after
MINRES (refine_steps=1): its refine_rel_res and its rel-L2 against a
projected-CG solve refined to 1e-11.  Then, for the port, MINRES stopped at
200 iterations: two solves (bit for bit?) and a 4-shard CPU mesh given the
one device's Y (rel-L2 of u).  chip_smoke.py's phase 19 takes its bounds
from these numbers.  About 15 minutes with 4 threads.
"""

import os
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [REPO, os.path.join(REPO, "tests")]

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from shm3d.solvers.grid import GridSolver as JaxGridSolver  # noqa: E402
from shm3d_torch import SignedHeatOptions, make_sphere_cloud  # noqa: E402
from shm3d_torch.ops.farfield import _positions_of  # noqa: E402
from shm3d_torch.parallel import device_mesh  # noqa: E402
from shm3d_torch.parallel.shards import shard_rows  # noqa: E402
from shm3d_torch.solvers import grid as tgrid  # noqa: E402
from shm3d_torch.utils.timing import PhaseTimer  # noqa: E402
from torch_interop import jax_geom, jax_options  # noqa: E402


def rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def solve(solver, geom, opts):
    t0 = time.perf_counter()
    phi = np.asarray(solver.compute_distance(geom, opts).phi, np.float64)
    return phi, dict(solver.last_stats), time.perf_counter() - t0


def probe(h_coef: float, geom) -> None:
    base = SignedHeatOptions(dtype="float32", h_coef=h_coef, refine_steps=0,
                             step1_method="shell", disk_cache=False)
    kkt = base.with_(solver_method="minres_kkt")
    ref_opts = base.with_(refine_steps=10, refine_target=1e-11)
    exact = None
    for name, solver, g, conv in (
            ("jax", JaxGridSolver(), jax_geom(geom), jax_options),
            ("port", tgrid.GridSolver(device="cpu"), geom, lambda o: o)):
        phi, st, s = solve(solver, g, conv(kkt))
        pcg, pst, _ = solve(solver, g, conv(base))
        ref, _, _ = solve(solver, g, conv(ref_opts))
        d, dst, ds = solve(solver, g, conv(kkt.with_(refine_steps=1)))
        if exact is None:
            grid = next(iter(solver._cache.values()))["grid"]
            pos = _positions_of(np.arange(grid.n ** 3, dtype=np.int64), grid)
            exact = np.linalg.norm(pos.astype(np.float64), axis=1) - 1.0
            print(f"h_coef {h_coef}: grid {grid.n}^3", flush=True)
        print(f"  {name}: minres_kkt {st['iters']} iterations, phibar {st['rel_res']:.4e}, "
              f"{s:.1f} s; projected_cg {pst['iters']} iterations; rel-L2 vs projected CG "
              f"{rel(phi, pcg):.4e}, vs |x|-1 {rel(phi, exact):.4e} (projected CG "
              f"{rel(pcg, exact):.4e}); default tier after MINRES: refine_rel_res "
              f"{dst.get('refine_rel_res')}, passes {dst.get('refine_pass_rels')}, rel-L2 vs the "
              f"refined reference {rel(d, ref):.4e}, {ds:.1f} s", flush=True)

    # the port at 200 iterations: repeatability and a 4-shard mesh given one Y
    opts = kkt.with_(solver_maxiter=200)
    one = tgrid.GridSolver(device="cpu")
    a = one.compute_distance(geom, opts)
    b = one.compute_distance(geom, opts)
    cached = next(iter(one._cache.values()))
    grid = cached["grid"]
    mesh = device_mesh(devices=["cpu"] * 4)
    sm = tgrid.GridSolver(mesh=mesh)
    u = sm._integrate_exact(shard_rows(a.Y, mesh), sm._slab_tables(cached, grid), grid, False,
                            opts.resolved_solver_tol(), opts, PhaseTimer(torch.device("cpu")))
    print(f"  port, solver_maxiter=200: {one.last_stats['iters']} iterations, phibar "
          f"{one.last_stats['rel_res']:.4e}; two solves bitwise equal "
          f"{np.array_equal(a.phi, b.phi)}; 4 shards given one Y: {sm.last_stats['iters']} "
          f"iterations, phibar {sm.last_stats['rel_res']:.4e}, rel-L2 of u vs one device "
          f"{rel(u.gather().numpy(), a.u_device.numpy()):.4e}", flush=True)


def main() -> None:
    torch.set_num_threads(4)
    geom = make_sphere_cloud(52290)
    for h in [float(a) for a in sys.argv[1:]] or [1.0, 2.0]:
        probe(h, geom)


if __name__ == "__main__":
    main()
