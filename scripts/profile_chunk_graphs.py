#!/usr/bin/env python3
"""The Krylov chunk graphs (shm3d_torch.solve.graphs.ChunkGraph: a
conditional node written by hand around a body captured by torch) under
torch.profiler, each case in a process of its own, so that a fault in one
leaves the others their context:

- ``cond``: one chunk graph whose body adds 1 to a counter and runs the CG
  stop kernel to a maxiter of 3, captured and built under the profiler,
  launched 200 times under it, dropped and rebuilt 20 times under it; the
  counter checked after every launch;
- ``main``: the main path (sphere52k-128, fast tier), its cold solve on
  the eager loops and stages under the profiler, then 4 graphed solves
  under it, the first capturing the graphs there;
- ``minres``: the same input with MINRES on the KKT system at 200
  iterations, as ``main``;
- ``vertex``: knot_dec's vertex path, its cold eager solve under the profiler,
  one graphed solve outside it, its graphs dropped and captured again by
  the first of 4 graphed solves under it (the order of the one
  chip_smoke.py run that ended in an illegal memory access).

Each graphed solve's phi is compared bit for bit with the eager solve's.
For each case prints whether it ran to its end, the kernel events the
profiler recorded (against the eager solve's) and their device time, or
the error that stopped it; for the solves, the median of 3 unprofiled warm
graphed solves after them, and each profiled solve's busy share: its
kernel time over that median.  The profiler records the kernels inside a
conditional node's body only for graphs captured while it runs (all of
them on the main path, not always on the vertex path): a busy share
counts as measured where the trace holds the graphed solve's every kernel.

    python3 scripts/profile_chunk_graphs.py [cond main vertex]

Needs an NVIDIA GPU; ~3 min."""

import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

KNOT = os.path.join(REPO, "tests", "data", "knot_dec.obj")
CASES = ("cond", "main", "minres", "vertex")


def kernel_events(prof) -> tuple:
    """(kernel events, their device time in ms) of a profile."""
    ks = [e for e in prof.profiler.kineto_results.events()
          if str(e.device_type()).endswith("CUDA")
          and not e.name().startswith(("Memcpy", "Memset"))]
    return len(ks), sum(e.duration_ns() for e in ks) / 1e6


def profiled(fn):
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, kernel_events(prof)


def cond_case() -> dict:
    from shm3d_torch.solve import graphs, stop

    dev = torch.device("cuda", 0)
    fresh = torch.zeros(stop.NSLOTS, dtype=torch.float64)
    fresh[:5] = stop.params(0.0, 3, 1 << 30, 1e-38)
    events = []

    def build():
        count = torch.zeros((), dtype=torch.int64, device=dev)
        rz = torch.ones((), device=dev)
        st, go = stop.new_state(dev)
        chunk = stop.CondGraph(dev, True)
        body = torch.cuda.CUDAGraph(keep_graph=True)
        with graphs.LaunchCounts().recording(), stop.chunk_condition(chunk.handle), \
                torch.cuda.graph(body):
            count.add_(1)
            stop.cg_stop_cuda(rz, None, st, go, False)
        chunk.build(body.raw_cuda_graph(), go)
        return chunk, body, count, st, go

    def launches(parts, n):
        chunk, _, count, st, go = parts
        for _ in range(n):
            st.copy_(fresh)
            go.fill_(True)
            chunk.launch(torch.cuda.current_stream(dev))
            if int(count.item()) % 3:
                raise RuntimeError(f"the body ran {int(count.item())} times, not 3 a launch")

    def rebuild():
        parts = build()
        launches(parts, 5)
        return parts

    parts, n = profiled(build)
    events.append(n)
    _, n = profiled(lambda: launches(parts, 200))
    events.append(n)
    for _ in range(20):
        del parts
        parts, n = profiled(rebuild)
        events.append(n)
    return dict(kernel_events=[n for n, _ in events], expected_a_launch=6)


def solve_case(name: str) -> dict:
    from shm3d_torch import SignedHeatOptions, SignedHeatSolver, make_sphere_cloud
    from shm3d_torch.io.mesh_io import read_geometry
    from shm3d_torch.solve import graphs

    if name in ("main", "minres"):
        geom = make_sphere_cloud(52290)
        opts = SignedHeatOptions(dtype="float32", h_coef=3, refine_steps=0,
                                 solver_maxiter=2000, disk_cache=False)
        if name == "minres":
            opts = opts.with_(solver_method="minres_kkt", solver_maxiter=200)
        solver = SignedHeatSolver("grid", device="cuda")
    else:
        geom = read_geometry(KNOT)
        opts = SignedHeatOptions(use_crouzeix_raviart=False, disk_cache=False)
        solver = SignedHeatSolver("tet", device="cuda")

    def digest(phi=None):
        phi = solver.compute_distance(geom, opts).phi if phi is None else phi
        return hashlib.sha1(np.ascontiguousarray(phi).tobytes()).hexdigest()

    saved = [getattr(graphs, n) for n in ("runner", "stage_runner")]
    graphs.runner = graphs.stage_runner = lambda *args, **kw: None
    try:
        eager, (eager_events, eager_ms) = profiled(digest)
    finally:
        graphs.runner, graphs.stage_runner = saved
    if name == "vertex":
        digest()
        next(iter(solver._impl._cache.values())).pop("vertex_graphs")
    got, events = [], []
    for _ in range(4):
        h, n = profiled(digest)
        got.append(h == eager)
        events.append(n)
    warm = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        phi = solver.compute_distance(geom, opts).phi
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
        got.append(digest(phi) == eager)
    median = sorted(warm)[1]
    return dict(bitwise=got, kernel_events=[n for n, _ in events],
                kernel_ms=[ms for _, ms in events], eager_kernel_events=eager_events,
                eager_kernel_ms=eager_ms, warm_s=warm,
                busy=[ms / 1e3 / median for _, ms in events[1:]])


def run_case(name: str) -> int:
    t0 = time.perf_counter()
    out = cond_case() if name == "cond" else solve_case(name)
    out["seconds"] = round(time.perf_counter() - t0, 1)
    print(f"RESULT {name} {json.dumps(out)}", flush=True)
    return 0


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--case":
        return run_case(sys.argv[2])
    if not torch.cuda.is_available():
        print("profile_chunk_graphs: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(f"gpu: {smi}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    failed = 0
    for name in sys.argv[1:] or CASES:
        p = subprocess.run([sys.executable, os.path.abspath(__file__), "--case", name],
                           capture_output=True, text=True, timeout=900)
        result = [ln for ln in p.stdout.splitlines() if ln.startswith("RESULT")]
        errors = [ln for ln in p.stderr.splitlines() if "Error" in ln or "error" in ln]
        print(f"{name}: exit {p.returncode}; {result[0] if result else 'no result'}; "
              f"{errors[-3:] if p.returncode else ''}", flush=True)
        failed += p.returncode != 0
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
