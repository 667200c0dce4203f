#!/usr/bin/env python3
"""The two readings a cell's comparison limits are set from, on the card at
the cell's own size:

- the lower: the program's sound runs, one a seed: the cell's cold solve
  and one warm solve through ``SignedHeatSolver``, the warm one held
  against the float64 reference;
- the upper: the control, the reference put in the program's place and
  computed one precision lower (``--controls``, default bfloat16; float32
  with TF32 products as a second reading), held against the same float64
  reference, on the ``--control-seeds`` (each also one of ``--seeds``, so
  the host half of the reference is made once for both).

    python3 bench_port/readings.py --workload <cell> --seeds 1,2,3 --control-seeds 1,2

Prints one JSON line a seed and, last, the largest program reading and
the smallest control reading of each number.  The benchmark's own runs do
not run this.
"""

import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

import run  # noqa: E402


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--controls", default="bf16,tf32")
    args = ap.parse_args(argv)
    run.set_environment()
    import gc

    import numpy as np
    import torch

    from harness import manifest
    from shm3d_torch import SignedHeatSolver

    if not torch.cuda.is_available():
        print("no card visible", file=sys.stderr)
        return 2
    device = torch.device("cuda:0")
    torch.empty(1, device=device)
    wl = manifest.workload(args.workload)
    cfg = manifest.config(wl["config"])
    opts = run.cell_options(cfg, wl)
    ref_mod = manifest.reference_module(cfg["reference"])
    maker = manifest.geometry_module(cfg["geometry"]["maker"])
    seeds = [int(s) for s in args.seeds.split(",")]
    ctl_seeds = {int(s) for s in args.control_seeds.split(",") if s}
    controls = [c for c in args.controls.split(",") if c]
    lower, upper = {}, {c: {} for c in controls}
    for seed in seeds:
        t0 = time.perf_counter()
        inputs = maker.make(cfg["geometry"], np.random.default_rng(seed % 2 ** 64))
        solver = SignedHeatSolver(cfg["domain"], device="cuda")
        geom, options = run.port_geometry(inputs), run.port_options(opts)
        solver.compute_distance(geom, options)
        res = solver.compute_distance(geom, options)
        out = run.port_output(res)
        stats = run._plain(solver.last_stats)
        del solver, res, geom
        gc.collect()
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        disc = ref_mod.discretize(inputs, opts, port=out)
        ref = ref_mod.solve(inputs, opts, device, disc=disc)
        nums = ref_mod.numbers(out, ref)
        line = {"seed": seed, "program": nums, "port_s": t1 - t0,
                "ref_info": ref["info"], "iters": stats.get("iters"),
                "proj_iters": stats.get("proj_iters")}
        for k, v in nums.items():
            lower[k] = max(lower.get(k, v), v)
        if seed in ctl_seeds:
            for c in controls:
                try:
                    ctl = ref_mod.solve(inputs, opts, device, control=c, disc=disc)
                    cn = ref_mod.numbers(ctl, ref)
                    line[c] = dict(cn, info=ctl["info"])
                except (FloatingPointError, RuntimeError) as e:
                    line[c] = {"failed": repr(e)}
                    continue
                for k, v in cn.items():
                    upper[c][k] = min(upper[c].get(k, v), v)
        print(json.dumps(line, default=repr), flush=True)
        del ref, disc
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload, "seeds": seeds,
                      "lower": lower, "upper": upper}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
