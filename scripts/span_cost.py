#!/usr/bin/env python3
"""The span recorder's own host cost (``shm3d_torch.utils.timing``) on the
machine it runs on, with no profiler running: a recorded solve of N empty
spans (the root span, the counters read at its start and end, N spans
entered and left), then the deep copy of its ``last_stats`` that the
benchmark takes after every solve, against the same loop with no recorder
active (each span then a no-op).  The cost a solve is the difference.

    python3 scripts/span_cost.py [--spans 20,50,100] [--repeats 2000]

Prints one JSON line: microseconds a solve for each N, with and without
the recorder, and their difference.  A cell's N is the length of a warm
solve's ``last_stats["spans"]`` (the benchmark prints the last solve's
stats on standard error).
"""

import argparse
import copy
import json
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from shm3d_torch.utils import timing  # noqa: E402


def one_solve(n: int, recorded: bool) -> None:
    stats = {}
    if recorded:
        with timing.PhaseTimer(torch.device("cpu")).solve(stats):
            for _ in range(n):
                with timing.span("span", timing.HOST):
                    pass
    else:
        for _ in range(n):
            with timing.span("span", timing.HOST):
                pass
    copy.deepcopy(stats)


def per_solve_us(n: int, recorded: bool, repeats: int) -> float:
    """The median of 5 timings of ``repeats`` solves, in microseconds a
    solve."""
    out = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(repeats):
            one_solve(n, recorded)
        out.append((time.perf_counter() - t0) / repeats * 1e6)
    return statistics.median(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--spans", default="20,50,100")
    ap.add_argument("--repeats", type=int, default=2000)
    args = ap.parse_args(argv)
    if timing.profiling():
        print("a profiler is running: the cost measured would be the traced one",
              file=sys.stderr)
        return 2
    out = {}
    for n in (int(x) for x in args.spans.split(",")):
        for recorded in (False, True):
            one_solve(n, recorded)  # warm-up
        on = per_solve_us(n, True, args.repeats)
        off = per_solve_us(n, False, args.repeats)
        out[n] = {"recorded_us": round(on, 2), "unrecorded_us": round(off, 2),
                  "cost_us": round(on - off, 2)}
    print(json.dumps({"per_solve": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
