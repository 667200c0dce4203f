#!/usr/bin/env python3
"""Look for order-dependent device operations on the grid domain's solve
path, on one NVIDIA GPU.

    python3 scripts/deterministic_grid.py

Runs chip_smoke.py's main-path input (a 52,290-point sphere cloud on a 128^3
grid, float32) through ``SignedHeatSolver("grid", device="cuda")``, the
fast tier (refine_steps=0) and the default tier (refine_steps=1), twice
each in PyTorch's default mode and once each under
``torch.use_deterministic_algorithms(True)``, which raises on any CUDA
operation that has no deterministic implementation and switches the others
to theirs.  Prints a hash of each phi; exits 0 when every run of a tier
gave the same phi bit for bit (so no operation on the path depends on the
order of its threads), 1 otherwise.  The mode is set here only, never in
the library.

Then it measures what the order of A^T's sums does to the fast tier's
accuracy: the rel-L2 of the fast tier against the same discretization
refined to 1e-11, with A^T as the library computes it (a gather over the
transposed constraint table, one fixed order) and four times with A^T as a
scatter-add through CUDA atomics (``index_add_``, an order that changes
from run to run), the rest of the solve unchanged.
"""

import hashlib
import json
import os
import sys

import numpy as np

# cuBLAS takes a fixed workspace under the deterministic mode
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import torch  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from shm3d_torch import SignedHeatOptions, SignedHeatSolver, make_sphere_cloud

    geom = make_sphere_cloud(52290)
    base = SignedHeatOptions(dtype="float32", h_coef=3.0, solver_maxiter=2000,
                             step1_method="auto", disk_cache=False)
    solver = SignedHeatSolver("grid", device="cuda")
    out = {}
    for refine in (0, 1):
        opts = base.with_(refine_steps=refine)
        hashes = []
        for deterministic in (False, True, False):
            torch.use_deterministic_algorithms(deterministic)
            try:
                phi = solver.compute_distance(geom, opts).phi
            finally:
                torch.use_deterministic_algorithms(False)
            hashes.append(hashlib.sha1(phi.tobytes()).hexdigest()[:16])
            print(f"refine_steps={refine} deterministic={deterministic}: phi {hashes[-1]}, "
                  f"iters {solver.last_stats['iters']}, "
                  f"refine_pass_rels {solver.last_stats.get('refine_pass_rels')}", flush=True)
        out[f"refine_steps={refine}"] = hashes
    same = all(len(set(h)) == 1 for h in out.values())

    from shm3d_torch.solve import projection

    cached = next(iter(solver._impl._cache.values()))
    nodes8 = cached["nodes8"].reshape(-1)
    coeffs = {c.dtype: c for c in (cached["coeffs8"],
                                   torch.as_tensor(cached["coeffs8_f64"], device="cuda"))}

    def at_scatter(y, at, n):
        out = torch.zeros(n, dtype=y.dtype, device=y.device)
        return out.index_add_(0, nodes8, (coeffs[y.dtype] * y[:, None]).reshape(-1))

    ref = solver.compute_distance(geom, base.with_(refine_steps=10, refine_target=1e-11)).phi

    def rel_fast():
        phi = solver.compute_distance(geom, base.with_(refine_steps=0)).phi
        return float(np.linalg.norm(phi - ref) / np.linalg.norm(ref))

    fixed = rel_fast()
    gather = projection.at_apply
    projection.at_apply = at_scatter
    try:
        atomic = [rel_fast() for _ in range(4)]
    finally:
        projection.at_apply = gather
    print(f"rel_l2_fast_tier against the refined reference: {fixed:.6e} with A^T "
          f"in one fixed order; {[float('%.6e' % r) for r in atomic]} with A^T "
          f"through CUDA atomics", flush=True)
    print(json.dumps({"one_phi_per_tier": same, "phi_sha1": out,
                      "rel_l2_fast_tier_fixed_order": fixed,
                      "rel_l2_fast_tier_atomic_order": atomic}))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
