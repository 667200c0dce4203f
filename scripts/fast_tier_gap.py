#!/usr/bin/env python3
"""Split the grid fast tier's distance from its refined reference into its
parts, on one NVIDIA GPU.

    python3 scripts/fast_tier_gap.py [--skip-cpu] [--skip-jax]

(``--device cpu --n-points 2000 --h-coef 1`` rehearses it on the CPU at a
small size; its numbers then say nothing about the card.)

Input: chip_smoke.py's main path (a 52,290-point sphere cloud on a 128^3
grid, float32, refine_steps=0; the full-row whitening tier).  The reference
is the same discretization refined to 1e-11 (refine_steps=10) on the card.
Each row swaps one part of the port's fast tier for a version without its
rounding and prints rel-L2 against the reference, the primary solve's
iterations and its relative residual:

- baseline: the library as it is;
- K1 -> plain: Steps 1-2 through ``yukawa_field_torch`` (exact exp and
  rsqrt, one minimum a query) instead of the CUDA kernel;
- tmat in float64: the full-row factor built in float64 on the card and
  rounded to float32 (the library builds it in float32);
- V-cycle in float64: the preconditioner's smoother, transfers and pin
  masks in float64 on a widened residual, rounded back;
- all three swaps together;
- the same port solve on the CPU in float32 (the card against the code);
- the JAX package's fast tier and its own refined reference on the CPU
  with JAX's x64 off (float32, as on the TPU), in a subprocess: its
  iterations, its residual, and its rel-L2 against either reference.

Writes every row to chiprun_out/fast_tier_gap.json.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_POINTS, H_COEF = 52290, 3.0

_JAX_RUN = r"""
import json, sys, time
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
from shm3d.config import SignedHeatOptions
from shm3d.geometry.procedural import make_sphere_cloud
from shm3d.solvers.grid import GridSolver
out_dir = sys.argv[1]
geom = make_sphere_cloud(%(n)d)
opts = SignedHeatOptions(dtype="float32", h_coef=%(h)r, refine_steps=0,
                         solver_maxiter=2000, step1_method="auto", disk_cache=False)
s = GridSolver()
t0 = time.perf_counter()
fast = s.compute_distance(geom, opts).phi
st = dict(s.last_stats, fast_s=time.perf_counter() - t0)
ref = s.compute_distance(geom, opts.with_(refine_steps=10, refine_target=1e-11)).phi
st["ref_refine_pass_rels"] = s.last_stats.get("refine_pass_rels")
np.save(out_dir + "/jax_fast.npy", fast)
np.save(out_dir + "/jax_ref.npy", ref)
print(json.dumps({k: st[k] for k in ("iters", "rel_res", "fast_s", "ref_refine_pass_rels")}))
"""


def rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--skip-cpu", action="store_true", help="leave out the port's CPU solve")
    ap.add_argument("--skip-jax", action="store_true", help="leave out the JAX package's solve")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n-points", type=int, default=N_POINTS)
    ap.add_argument("--h-coef", type=float, default=H_COEF)
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        print("fast_tier_gap: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from shm3d_torch import SignedHeatOptions, make_sphere_cloud
    from shm3d_torch.ops import farfield
    from shm3d_torch.ops import yukawa as yk
    from shm3d_torch.solve import multigrid, projection
    from shm3d_torch.solvers.grid import GridSolver

    smi = (subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
           if args.device == "cuda" else "cpu")
    print(f"gpu: {smi}", flush=True)
    geom = make_sphere_cloud(args.n_points)
    opts = SignedHeatOptions(dtype="float32", h_coef=args.h_coef, refine_steps=0,
                             solver_maxiter=2000, step1_method="auto", disk_cache=False)
    solver = GridSolver(device=args.device)
    solver.compute_distance(geom, opts)  # cold: host precompute, factor, shell plan
    ref = solver.compute_distance(geom, opts.with_(refine_steps=10, refine_target=1e-11))
    ref_phi = ref.phi
    print(f"reference: refine_pass_rels {solver.last_stats['refine_pass_rels']}", flush=True)
    cached = next(iter(solver._cache.values()))
    gram32 = cached["gram"]
    rows = []

    def solve(name, s=solver):
        t0 = time.perf_counter()
        phi = s.compute_distance(geom, opts).phi
        row = dict(swap=name, rel_l2=rel(phi, ref_phi), iters=s.last_stats["iters"],
                   rel_res=float(s.last_stats["rel_res"]), s=time.perf_counter() - t0)
        rows.append(row)
        print(f"  {name:34s} rel-L2 {row['rel_l2']:.4e}  iters {row['iters']:4d}  "
              f"rel_res {row['rel_res']:.3e}  ({row['s']:.2f} s)", flush=True)
        return phi

    def k1_plain(q, p, v, lam):
        return yk.yukawa_field_torch(q, p, v, lam)

    def tmat64():
        if gram32.tmat is None:  # a rehearsal's size takes the bmat tier
            return gram32
        T = projection._device_tform(gram32.idx, gram32.val.double(), gram32.diag.double(),
                                     float(gram32.tform_eps))
        return gram32._replace(tmat=projection.tri_pack(T.float()))

    orig_precond = multigrid.make_node_preconditioner

    def precond64(shape, cell, pins=None):
        p64 = None if pins is None else tuple(p.double() for p in pins)
        inner = orig_precond(shape, cell, pins=p64)
        return lambda r: inner(r.double()).to(r.dtype)

    print(f"sphere cloud S={args.n_points}, {cached['grid'].n}^3, float32, refine_steps=0, "
          f"m={cached['nodes8'].shape[0]}, tform_eps {gram32.tform_eps} ({smi})", flush=True)
    solve("baseline")
    farfield.yukawa_field = k1_plain
    solve("K1 -> yukawa_field_torch")
    farfield.yukawa_field = yk.yukawa_field
    cached["gram"] = tmat64()
    solve("tmat built in float64, rounded")
    cached["gram"] = gram32
    multigrid.make_node_preconditioner = precond64
    solve("V-cycle in float64")
    farfield.yukawa_field = k1_plain
    cached["gram"] = tmat64()
    solve("all three swaps")
    farfield.yukawa_field = yk.yukawa_field
    multigrid.make_node_preconditioner = orig_precond
    cached["gram"] = gram32
    solve("baseline again")

    if not args.skip_cpu:
        cpu = GridSolver(device="cpu")
        cpu.compute_distance(geom, opts)  # cold
        solve("port on the CPU (float32)", cpu)
        del cpu

    if not args.skip_jax:
        with tempfile.TemporaryDirectory() as tmp:
            env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
            t0 = time.perf_counter()
            out = subprocess.run([sys.executable, "-c", _JAX_RUN % dict(n=args.n_points, h=args.h_coef), tmp],
                                 capture_output=True, text=True, env=env, timeout=1800)
            if out.returncode != 0:
                print(out.stderr[-3000:], file=sys.stderr)
                return 1
            st = json.loads(out.stdout.strip().splitlines()[-1])
            fast, jref = np.load(f"{tmp}/jax_fast.npy"), np.load(f"{tmp}/jax_ref.npy")
        jax_row = dict(swap="JAX package on the CPU (x64 off)", iters=st["iters"],
                       rel_res=st["rel_res"], rel_l2=rel(fast, jref),
                       rel_l2_vs_port_reference=rel(fast, ref_phi),
                       references_differ_by=rel(jref, ref_phi),
                       ref_refine_pass_rels=st["ref_refine_pass_rels"],
                       s=time.perf_counter() - t0)
        rows.append(jax_row)
        print(f"  JAX package, CPU, x64 off: rel-L2 {jax_row['rel_l2']:.4e} against its own "
              f"reference, {jax_row['rel_l2_vs_port_reference']:.4e} against the port's; "
              f"iters {st['iters']}, rel_res {st['rel_res']:.3e}; the two references differ "
              f"by {jax_row['references_differ_by']:.3e}", flush=True)

    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "fast_tier_gap.json"), "w") as fh:
        json.dump(dict(gpu=smi, rows=rows), fh, indent=1)
    print(json.dumps(dict(gpu=smi, rows=rows)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
