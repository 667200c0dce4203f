#!/usr/bin/env python3
"""The grid fast tier's distance from its refined reference, the port
against the JAX package, both on the CPU in float32 at 64^3 (the full-row
whitening tier, ORTHO_GRAM_CAP set to 0 in both packages).

    JAX_PLATFORMS=cpu python3 scripts/fast_tier_gap_cpu.py [N_POINTS ...]

For each sphere cloud of N_POINTS (default 2000 5000 12000) prints rel-L2
against the port's solve refined to 1e-11, the iterations and the relative
residual of: the JAX package's fast tier; the port's; the port's with A^T
as a scatter-add (the JAX package's order); with the cell size rounded to
float32 (as the JAX package holds it); and with the JAX package's Step-2
field.  A difference that follows the input and not the package is
float32 rounding; one that the port shows on every input is arithmetic.
"""

import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [REPO, os.path.join(REPO, "tests")]

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from shm3d.solve import projection as jproj  # noqa: E402
from shm3d.solvers.grid import GridSolver as JaxGridSolver  # noqa: E402
from shm3d_torch import SignedHeatOptions, make_sphere_cloud  # noqa: E402
from shm3d_torch.domains import grid as griddom  # noqa: E402
from shm3d_torch.solve import projection  # noqa: E402
from shm3d_torch.solvers import grid as tgrid  # noqa: E402
from torch_interop import jax_geom, jax_options  # noqa: E402


def probe(n_points: int) -> None:
    geom = make_sphere_cloud(n_points)
    opts = SignedHeatOptions(dtype="float32", h_coef=2.0, refine_steps=0,
                             disk_cache=False, solver_maxiter=2000)
    ts = tgrid.GridSolver(device="cpu")
    ref = ts.compute_distance(geom, opts.with_(refine_steps=10, refine_target=1e-11)).phi
    cached = next(iter(ts._cache.values()))
    print(f"sphere cloud S={n_points}, {cached['grid'].n}^3, float32, m="
          f"{cached['nodes8'].shape[0]}, tier {ts.last_stats['tier']}; reference passes "
          f"{ts.last_stats['refine_pass_rels']}")

    def row(name, solver, phi):
        rel = float(np.linalg.norm(phi - ref) / np.linalg.norm(ref))
        print(f"  {name:28s} rel-L2 {rel:.4e}  iters {solver.last_stats['iters']}  "
              f"rel_res {float(solver.last_stats['rel_res']):.4e}", flush=True)

    js = JaxGridSolver()
    jres = js.compute_distance(jax_geom(geom), jax_options(opts))
    row("JAX package", js, jres.phi)
    row("port", ts, ts.compute_distance(geom, opts).phi)

    at_apply = projection.at_apply
    nodes8 = cached["pin_nodes8"].reshape(-1)
    coeffs8 = cached["pin_coeffs8"]
    projection.at_apply = lambda y, at, n: torch.zeros(n, dtype=y.dtype).index_add_(
        0, nodes8, (coeffs8 * y[:, None]).reshape(-1))
    row("port, A^T scatter-add", ts, ts.compute_distance(geom, opts).phi)
    projection.at_apply = at_apply

    g = cached["grid"]
    cached["grid"] = griddom.GridSpec(g.bbox_min, float(np.float32(g.cell_size)), g.n)
    row("port, cell size in float32", ts, ts.compute_distance(geom, opts).phi)
    cached["grid"] = g

    Yj = torch.as_tensor(np.array(jres.Y, dtype=np.float32))
    field = tgrid.yukawa_field
    tgrid.yukawa_field = lambda q, p, v, lam: Yj
    row("port, the JAX package's Y", ts, ts.compute_distance(geom, opts).phi)
    tgrid.yukawa_field = field


def main() -> int:
    torch.set_num_threads(os.cpu_count() or 1)
    jproj.ORTHO_GRAM_CAP = 0
    projection.ORTHO_GRAM_CAP = 0
    for n in [int(a) for a in sys.argv[1:]] or [2000, 5000, 12000]:
        probe(n)
    return 0


if __name__ == "__main__":
    sys.exit(main())
