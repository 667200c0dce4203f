#!/usr/bin/env python3
"""Run one cell of the shm3d_torch benchmark once, on the card it starts on.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell (``workloads/<cell>.json``) is one deployment (``configs/<name>.json``)
re-solved in a closed loop by one caller: ``SignedHeatSolver(domain,
device="cuda").compute_distance(geom, options)`` back to back on one
geometry made from the seed, each request ending when phi is on the host
as NumPy (``result.phi``) and fenced by ``torch.cuda.synchronize()``.

Set-up (``setup_s``, from the first statement of this file to the window's
start): imports, the kernel build (served from ``shm3d_torch/_build/``
after a checkout's first run), the inputs, the cold solve (the program's
host precompute, its device upload, its graph captures) and the warm-up
solves.  Then the window: solves back to back for ``--seconds``; the last
one started inside it ends it.  With ``--trace 1`` the profiler runs from
before the cold solve (so the graphs are captured under it) and the window
is a fixed number of traced solves, each after a marker kernel.  The
profiler's cost is weighed against untraced solves of the same run: the
set-up's warm solves where the profiler starts after them, else as many
solves again once it has stopped.

After the window: the device's peak is read, the program's state freed,
and a solve of the window is held against the plain reference
(``reference/<name>.py``), run on the card in float64; each compared
number is printed beside its limit.  The last line of standard output is
the result, one JSON object.

The run fails without a result where no card is visible, where the cell
asks for more cards than there are, where the program is absent, and where
JAX or the JAX package ``shm3d`` was loaded in this process.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import copy  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
CACHE = BENCH / "_cache"

# the program's launch and read counters, read as deltas over the window
COUNTER_MODULES = ("shm3d_torch.ops.yukawa", "shm3d_torch.solve.pell",
                   "shm3d_torch.solve.stop", "shm3d_torch.solve.graphs")


def set_environment() -> None:
    """Every cache the program or its libraries may write, at fixed paths
    inside the checkout (the kernel library builds into
    ``shm3d_torch/_build/`` by itself)."""
    os.environ["SHM3D_CACHE_DIR"] = str(CACHE / "shm3d")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(CACHE / "nv")


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def port_geometry(inputs: dict):
    """The program's geometry type for the benchmark's inputs (copies: the
    program may memoize on them)."""
    import numpy as np
    from shm3d_torch.io.mesh_io import Mesh, PointCloud

    if inputs["kind"] == "cloud":
        return PointCloud(inputs["positions"].copy(), inputs["normals"].copy())
    faces = np.asarray(inputs["faces"], np.int64)
    return Mesh(inputs["vertices"].copy(), faces.copy(),
                np.full(faces.shape[0], faces.shape[1], np.int64))


def cell_options(cfg: dict, wl: dict) -> dict:
    return {**cfg["options"], **wl.get("options", {})}


def port_options(opts: dict):
    from shm3d_torch import LevelSetConstraint, SignedHeatOptions

    o = dict(opts)
    if "level_set_constraint" in o:
        o["level_set_constraint"] = LevelSetConstraint(o["level_set_constraint"])
    return SignedHeatOptions(**o)


def counters() -> dict:
    out = {}
    for name in COUNTER_MODULES:
        mod = importlib.import_module(name)
        for k, v in vars(mod).items():
            if (k.isupper() and type(v) is int
                    and (k.endswith("LAUNCHES") or k.endswith("READS"))):
                out[f"{name}.{k}"] = v
    return out


def delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after}


def port_output(res) -> dict:
    """What the comparison reads of a solve, copied to the host now (a
    graph's output buffer is overwritten by the next replay)."""
    import numpy as np

    Y = res.Y
    Y = Y.detach().cpu().numpy() if hasattr(Y, "detach") else np.asarray(Y)
    out = {"Y": Y, "phi": np.array(res.phi, copy=True)}
    mesh = getattr(res, "mesh", None)
    if mesh is not None:
        # the tet domain's mesh, which the reference checks and solves on
        out["mesh_vertices"] = np.array(mesh.vertices, copy=True)
        out["mesh_tets"] = np.array(mesh.tets, copy=True)
    return out


class Loop:
    """The closed loop of one caller on one solver and geometry."""

    def __init__(self, solver, geom, options, device):
        import torch

        self.solver, self.geom, self.options = solver, geom, options
        self.cuda = device.type == "cuda"
        self.sync = torch.cuda.synchronize if self.cuda else (lambda: None)
        self.peak = torch.cuda.max_memory_allocated if self.cuda else (lambda: 0)
        self.latencies, self.peaks, self.stats = [], [], []

    def solve(self):
        t0 = time.perf_counter()
        res = self.solver.compute_distance(self.geom, self.options)
        res.phi  # the request ends with phi on the host
        self.sync()
        self.latencies.append(time.perf_counter() - t0)
        self.peaks.append(self.peak())
        self.stats.append(copy.deepcopy(self.solver.last_stats))
        return res


def compare(ref_mod, kept: list, ref: dict, limits: dict) -> dict:
    """Each compared number, the worst over the kept solves, beside its
    limit; numbers without a limit are readings only."""
    worst: dict = {}
    for out in kept:
        for k, v in ref_mod.numbers(out, ref).items():
            worst[k] = max(worst.get(k, v), v)
    missing = sorted(set(limits) - set(worst))
    if missing:
        raise KeyError(f"the reference gives no number for the limits {missing}")
    return worst


def drive(args, device) -> dict:
    """One run of a cell on ``device``: set-up, window, comparison and
    metrics.  Returns the result (without printing it) and the lines to
    print on standard error before it."""
    import numpy as np
    import torch

    from harness import guard, manifest, trace as trace_mod

    man = manifest.manifest()
    entry = manifest.cell_entry(man, args.workload)
    wl = manifest.workload(args.workload)
    cfg = manifest.config(wl["config"])
    rng = np.random.default_rng(args.seed % 2 ** 64)
    t_imp = time.perf_counter()
    import shm3d_torch  # noqa: F401
    from shm3d_torch import SignedHeatSolver
    from shm3d_torch import _build

    t_imported = time.perf_counter()
    inputs = manifest.geometry_module(cfg["geometry"]["maker"]).make(cfg["geometry"], rng)
    opts = cell_options(cfg, wl)
    geom, options = port_geometry(inputs), port_options(opts)
    if device.type == "cuda":
        # the program resets the allocator's peak at each call, which raises
        # before the process's first allocation on the card
        torch.empty(1, device=device)
    solver = SignedHeatSolver(cfg["domain"], device=str(device))
    loop = Loop(solver, geom, options, device)
    # the profiler runs from before the captures ("setup", so it sees the
    # kernels inside the graphs' conditional bodies) or from the window
    trace_from = wl.get("trace_from", "setup")
    prof = trace_mod.start() if args.trace and trace_from == "setup" else None
    t_inputs = time.perf_counter()

    loop.solve()
    cold_stats = loop.stats[0]
    for _ in range(int(wl["warm_solves"])):
        loop.solve()
    if args.trace and prof is None:
        prof = trace_mod.start()
    n_setup = len(loop.latencies)
    setup_s = time.perf_counter() - _T0

    kept, failed = [], 0
    spans = None
    c0 = counters()
    if args.trace:
        n = int(wl["trace_solves"])
        spans = trace_mod.GraphSpans() if trace_from == "window" else None
        t_start = time.perf_counter()
        with (spans or contextlib.nullcontext()):
            for i in range(n):
                trace_mod.mark()
                if i == 0 and spans is not None:
                    spans.mark_anchor()
                res = loop.solve()
                if i == 0 or i == n - 1:
                    kept.append(port_output(res))
            trace_mod.mark()
            loop.sync()
        t_end = time.perf_counter()
        c1 = counters()
        n_traced = len(loop.latencies)
        prof.stop()
        tr = trace_mod.Trace.from_profiler(prof, spans)
        del prof
        prof = None
        if trace_from == "setup":
            # every solve so far was traced: as many solves again with the
            # profiler stopped weigh its cost
            for _ in range(n):
                loop.solve()
            untraced = loop.latencies[n_traced:]
            del loop.latencies[n_traced:], loop.stats[n_traced:]
        else:
            # the set-up's warm solves ran before the profiler started
            untraced = loop.latencies[1:n_setup]
    else:
        pick = int(rng.integers(1, 9))
        t_start = time.perf_counter()
        i = 0
        while time.perf_counter() - t_start < args.seconds:
            try:
                res = loop.solve()
            except Exception as e:  # a failed request ends the window
                failed += 1
                print(f"solve {i} of the window failed: {e!r}", file=sys.stderr)
                break
            t_end = time.perf_counter()
            if i in (0, pick):
                kept.append(port_output(res))
            i += 1
        if i > 0:
            kept.append(port_output(res))
        c1 = counters()
        tr, untraced = None, []
    win_lat, win_peaks = loop.latencies[n_setup:], loop.peaks[n_setup:]
    memory_peak = max(loop.peaks)
    n_solves = len(win_lat)
    window_s = (t_end - t_start) if n_solves else 0.0
    found = guard.forbidden_loaded(sys.modules)

    # the program's state goes before the reference runs on the same card
    build_s = float(_build.BUILD_INFO.get("seconds", 0.0))
    win_stats = loop.stats[n_setup:]
    latencies = loop.latencies
    del loop, solver, geom
    res = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref_mod = manifest.reference_module(cfg["reference"])
    t_ref = time.perf_counter()
    limits = wl["limits"]
    try:
        ref = ref_mod.solve(inputs, opts, device, port=kept[0] if kept else None)
        numbers = compare(ref_mod, kept, ref, limits) if kept else {}
    except getattr(ref_mod, "Rejected", ()) as e:
        # the program's output is no discretization of the stated domain
        ref = {"info": {"rejected": str(e)}}
        numbers = {k: float("inf") for k in limits}
    ref_s = time.perf_counter() - t_ref
    found = sorted(set(found) | set(guard.forbidden_loaded(sys.modules)))

    phases = cold_stats.get("phases", {})
    precompute = sum(v for k, v in phases.items() if "precompute" in k)
    run = SimpleNamespace(
        setup_s=setup_s, window_s=window_s, latencies=win_lat, mem_peaks=win_peaks,
        n_solves=n_solves, cold_stats=cold_stats, window_stats=win_stats,
        counters=delta(c0, c1), trace=tr, untraced_latencies=untraced,
        ref_info=ref["info"], smi=_smi(device), workload=wl, config=cfg, inputs=inputs,
        notes=list(spans.notes) if spans is not None else [])
    metrics = {}
    for m in manifest.cell_metrics(man, args.workload, bool(args.trace)):
        v = manifest.metric_module(m["name"]).read(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    correct = (failed == 0 and n_solves > 0 and not found
               and all(numbers[k] <= lim for k, lim in limits.items()))
    result = {
        "correct": bool(correct),
        "attempted": n_solves,
        "failed": failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if device.type == "cuda" else device.type,
            "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
            "count": int(entry["chips"]),
            "memory_peak_bytes": int(memory_peak),
        },
    }
    if tr is not None:
        result["device"]["busy_s"] = tr.busy_ns() / 1e9
        result["device"]["window_s"] = tr.window_ns / 1e9
        result["breakdown"] = tr.breakdown(
            [list(s.get("phases", {}).items()) for s in win_stats])
    # a number that could not be compared (inf) is written as the largest
    # float, which JSON holds
    result["compared"] = {k: {"value": min(numbers[k], sys.float_info.max), "limit": lim}
                          for k, lim in limits.items()}

    io = _proc_io()
    lines = [
        f"cell {args.workload} seed {args.seed} trace {args.trace}"
        + (f": pose {np.array2string(np.asarray(inputs['pose']), precision=6, separator=',')}"
           if "pose" in inputs else ""),
        f"card {run.smi.get('name')} power.limit {run.smi.get('power.limit')} W "
        f"clocks.max.sm {run.smi.get('clocks.max.sm')} MHz",
        f"set-up {setup_s:.3f} s: imports {t_imported - t_imp:.3f} s (the harness's own "
        f"{t_imp - _T0:.3f} s), inputs {t_inputs - t_imported:.3f} s, cold solve "
        f"{latencies[0]:.3f} s (kernel build {build_s:.3f} s, host precompute "
        f"{precompute:.3f} s, the rest device upload, captures and the solve), warm "
        f"{', '.join(f'{x:.4f}' for x in latencies[1:n_setup])} s",
        f"window {window_s:.3f} s, {n_solves} solves, failed {failed}, latency "
        f"percentiles 5/50/90/95/99/100: "
        f"{_pcts(win_lat, (5, 50, 90, 95, 99, 100))} s; reference "
        f"{ref_s:.3f} s {json.dumps(ref['info'])}",
        f"untraced solves the profiler's cost is weighed against: "
        f"{', '.join(f'{x:.4f}' for x in untraced) or '-'} s",
        f"stats of the last solve: {json.dumps(_plain(win_stats[-1] if win_stats else {}))}",
        f"counters over the window: {json.dumps(run.counters)}",
        f"this process wrote {io.get('write_bytes', 'n/a')} bytes to storage "
        f"(wchar {io.get('wchar', 'n/a')}); build and cache directories hold "
        + ", ".join(f"{d.relative_to(ROOT)} {_du(d)} B" for d in
                    (ROOT / "shm3d_torch" / "_build", BENCH / "_build", CACHE)),
    ]
    lines += [f"note: {n}" for n in run.notes]
    if found:
        lines.append(f"forbidden modules loaded: {', '.join(found)}")
    if failed or not n_solves:
        lines.append(f"window: {n_solves} solves, {failed} failed")
    for k, v in numbers.items():
        lim = limits.get(k)
        lines.append(f"compared {k} {v:.6e} limit {lim:.6e}" if lim is not None
                     else f"reading {k} {v:.6e} (no limit)")
    return {"result": result, "stderr": lines, "found": found}


def _plain(obj):
    """``obj`` with what JSON cannot hold as its repr."""
    return json.loads(json.dumps(obj, default=repr))


def _smi(device) -> dict:
    if device.type != "cuda":
        return {}
    from harness import device as devmod

    return devmod.smi()


def _pcts(values, qs) -> str:
    import numpy as np

    return ", ".join(f"{np.percentile(values, q):.4f}" for q in qs) if len(values) else "-"


def _du(path: Path) -> int:
    return sum(p.stat().st_size for p in path.rglob("*") if p.is_file()) if path.exists() else 0


def _proc_io() -> dict:
    try:
        with open("/proc/self/io") as f:
            return dict((k.strip(), int(v)) for k, v in (ln.split(":") for ln in f))
    except OSError:
        return {}


def main(argv=None) -> int:
    args = parse(argv)
    set_environment()
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(BENCH))
    import torch

    from harness import manifest

    entry = manifest.cell_entry(manifest.manifest(), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(entry["chips"]):
        print(f"no result: the cell asks for {entry['chips']} CUDA device(s), "
              f"torch.cuda.is_available() is {torch.cuda.is_available()} and "
              f"{torch.cuda.device_count()} are visible", file=sys.stderr)
        return 2
    out = drive(args, torch.device("cuda:0"))
    if out["found"]:
        print("no result: the process loaded " + ", ".join(out["found"]), file=sys.stderr)
        return 3
    print(json.dumps(out["result"]), flush=True)
    for line in out["stderr"]:
        print(line, file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
