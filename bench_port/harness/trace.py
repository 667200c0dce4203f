"""A profiler trace of whole solves, reduced to what the per-layer metrics
read.

The traced run starts ``torch.profiler`` with CUDA activity only before the
set-up's first solve, so the graphs the port captures are captured while it
runs (only then does it record the kernels inside a conditional node's
body).  Each traced solve is preceded by a marker kernel
(``torch.cuda._sleep``, whose kernel the port never launches), and one more
follows the last: the solves' spans run from marker to marker on the
trace's clock.  Events are read raw from the profiler's results (its event
tree would take longer to build than the solves took).

Where graphs are captured before the profiler starts (a cell whose
captures fail under it), the kernels inside their conditional bodies are
not traced.  ``GraphSpans`` then times each chunk-graph launch with CUDA
events on its stream, anchored at the end of the first marker kernel, and
those spans count as device activity, the gaps between a graph's own
kernels with them: the busy time of such a cell is an upper bound.  Where
the program has no ``ChunkGraph._launch_chunk`` to time, the trace is
marked incomplete and its idle share is left out.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple

MARKER_CYCLES = 1000
MARKER_PATTERN = "spin_kernel"
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                "cuLaunchKernelEx")


def start():
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    return prof


def mark() -> None:
    """The marker kernel, on the current stream."""
    import torch

    torch.cuda._sleep(MARKER_CYCLES)


def merge(intervals: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """The union of half-open intervals, as disjoint sorted intervals."""
    out: List[List[int]] = []
    for a, b in sorted(intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def clip(intervals, lo: int, hi: int) -> List[Tuple[int, int]]:
    return [(max(a, lo), min(b, hi)) for a, b in intervals if b > lo and a < hi]


class GraphSpans:
    """CUDA events around every chunk-graph launch of the program
    (``shm3d_torch.solve.graphs.ChunkGraph._launch_chunk``) while active,
    and an anchor event recorded after the first marker kernel."""

    def __init__(self):
        self.pairs = []
        self.anchor = None
        self.notes = []
        self._orig = None

    def __enter__(self):
        import torch
        from shm3d_torch.solve import graphs

        orig = getattr(getattr(graphs, "ChunkGraph", None), "_launch_chunk", None)
        if orig is None:
            # the program has no such method any more: the trace alone
            # stands, its idle share left out (``device_idle_pct``)
            self.notes.append("graph spans: shm3d_torch.solve.graphs.ChunkGraph."
                              "_launch_chunk not found; chunk graphs not timed")
            return self
        pairs = self.pairs

        def launch(graph, i):
            stream = torch.cuda.current_stream(graph.device)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record(stream)
            orig(graph, i)
            e1.record(stream)
            pairs.append((e0, e1))

        self._orig = orig
        graphs.ChunkGraph._launch_chunk = launch
        return self

    @property
    def active(self) -> bool:
        return self._orig is not None

    def __exit__(self, *exc):
        from shm3d_torch.solve import graphs

        if self._orig is not None:
            graphs.ChunkGraph._launch_chunk = self._orig
        return False

    def mark_anchor(self) -> None:
        import torch

        self.anchor = torch.cuda.Event(enable_timing=True)
        self.anchor.record()

    def offsets_ns(self) -> List[Tuple[int, int]]:
        """(start, end) of each timed launch, in ns after the anchor."""
        if self.anchor is None:
            return []
        return [(int(self.anchor.elapsed_time(a) * 1e6), int(self.anchor.elapsed_time(b) * 1e6))
                for a, b in self.pairs]


class Trace:
    """Device activity (kernels, copies, fills) and the host's CUDA runtime
    calls, in nanoseconds on the trace's clock, cut to the traced solves.

    ``device``: (start, end, name) of every device event in the span;
    ``runtime``: (start, name) of every runtime call in the span;
    ``solves``: the (start, end) of each traced solve, from marker to
    marker; ``span``: from the first marker to the last."""

    GRAPHS = "chunk graphs, conditional bodies (timed by CUDA events)"

    def __init__(self, device, runtime, solves, graphs=(), complete=True):
        self.complete = complete
        self.device = device
        self.runtime = runtime
        self.solves = solves
        self.graphs = list(graphs)
        self.span = (solves[0][0], solves[-1][1]) if solves else (0, 0)

    @classmethod
    def from_profiler(cls, prof, spans: Optional[GraphSpans] = None) -> "Trace":
        device, runtime, markers = [], [], []
        for e in prof.profiler.kineto_results.events():
            name = e.name()
            start = e.start_ns()
            if str(e.device_type()).endswith("CUDA"):
                if MARKER_PATTERN in name:
                    markers.append((start, start + e.duration_ns()))
                else:
                    device.append((start, start + e.duration_ns(), name))
            else:
                runtime.append((start, name))
        markers.sort()
        solves = [(a[0], b[0]) for a, b in zip(markers[:-1], markers[1:])]
        lo, hi = (solves[0][0], solves[-1][1]) if solves else (0, 0)
        device = sorted(d for d in device if d[1] > lo and d[0] < hi)
        runtime = sorted(r for r in runtime if lo <= r[0] < hi)
        graphs = []
        if spans is not None and spans.active and markers:
            t0 = markers[0][1]
            graphs = [(t0 + a, t0 + b) for a, b in spans.offsets_ns()]
        complete = spans is None or spans.active
        return cls(device, runtime, solves, graphs, complete)

    @property
    def n_solves(self) -> int:
        return len(self.solves)

    @property
    def window_ns(self) -> int:
        return self.span[1] - self.span[0]

    def kernels(self, pattern: str) -> List[Tuple[int, int, str]]:
        """Device events whose name matches the regular expression."""
        rx = re.compile(pattern)
        return [d for d in self.device if rx.search(d[2])]

    def busy(self) -> List[Tuple[int, int]]:
        return merge(clip([(a, b) for a, b, _ in self.device] + self.graphs, *self.span))

    def busy_ns(self) -> int:
        return sum(b - a for a, b in self.busy())

    def launch_calls(self) -> int:
        """The host's kernel launch calls in the span, the markers' own
        launches left out (one each but the first, which opens the span
        after its own launch call)."""
        n = sum(1 for _, name in self.runtime if name in LAUNCH_CALLS)
        return n - (self.n_solves)

    def gaps(self) -> List[Tuple[int, int]]:
        busy = self.busy()
        lo, hi = self.span
        edges = [lo] + [x for ab in busy for x in ab] + [hi]
        return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]

    def breakdown(self, phases: Sequence[Sequence[Tuple[str, float]]],
                  top: int = 10) -> Dict[str, list]:
        """The device operations that took most time (by name, summed) and
        the longest idle gaps, each labelled with the solve's phase that
        holds it.  ``phases[i]``: solve i's (phase name, seconds) in order;
        phases end in a device sync, so their intervals rebuild from the
        solve's start."""
        by_name: Dict[str, int] = {}
        for a, b, name in self.device:
            by_name[name] = by_name.get(name, 0) + (min(b, self.span[1]) - max(a, self.span[0]))
        if self.graphs:
            by_name[self.GRAPHS] = sum(b - a for a, b in clip(self.graphs, *self.span))
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]

        def label(t: int) -> str:
            for i, (s0, s1) in enumerate(self.solves):
                if s0 <= t < s1:
                    acc = s0
                    for name, sec in (phases[i] if i < len(phases) else ()):
                        acc += int(sec * 1e9)
                        if t < acc:
                            return name
                    return "after the solve's phases: result to the host, harness"
            return "outside the solves"

        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:top]
        return {
            "device_ops": [[_short(n), ns / 1e9] for n, ns in ops],
            "idle_gaps": [[label((a + b) // 2), (b - a) / 1e9] for a, b in gaps],
        }


def _short(name: str, width: int = 160) -> str:
    return name if len(name) <= width else name[:width - 3] + "..."


def counted(trace: Optional[Trace], pattern: str, expected: int,
            what: str, notes: List[str]) -> Optional[List[Tuple[int, int, str]]]:
    """The kernel events matching ``pattern`` when their number is the
    port's own count ``expected`` over the same solves, else None with a
    note of why (a metric then stays out of the line)."""
    if trace is None or trace.n_solves == 0:
        return None
    ev = trace.kernels(pattern)
    if len(ev) != expected or expected == 0:
        notes.append(f"{what}: {len(ev)} kernel events in the trace against "
                     f"{expected} counted by the port over {trace.n_solves} solves; "
                     "metric left out")
        return None
    return ev
