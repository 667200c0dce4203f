"""The spans of a solve (shm3d.utils.timing's PhaseTimer, grown into the
port's span recorder) and a profiler trace.

A solve (``PhaseTimer.solve``) records a small tree of spans.  Its phases
are the spans under the root; each ends in a device synchronize, so a
phase covers the device work queued inside it, and ``last_stats["phases"]``
keeps each phase's seconds.  Inside them, spans of three kinds mark where
the work happens:

- ``host``: host compute that awaits nothing on the device (SciPy, NumPy,
  hashing, a host LU solve);
- ``wait``: the host blocks on the device (a copy to the host, a read of a
  device scalar, the phase-end synchronize);
- ``launch``: the enqueue of a graph replay, a chunk graph, or eager
  device work.

The root, the phases and the spans that group others (a device solve, a
defect-correction pass) are of kind ``group``.  Spans are per stage, per
solve or per pass, never per iteration: work repeated every iteration is
one ``tally`` span with a count and a total, so a solve holds a bounded
number of spans whatever its iteration count.

``last_stats["spans"]`` holds one tuple a span, ``(name, parent, kind,
start_ns, end_ns, attrs)``: ``parent`` the index of the parent span (-1 for
the root, and for spans recorded after the solve returned, such as
``GridResult.phi``'s copy), start and end from ``time.perf_counter_ns()``
relative to the root's start, ``attrs`` a tuple of (key, value) pairs:
``iters``, ``pass``, a tally's ``count`` and ``total_ns``, a launch span's
``device_ns``.  ``last_stats["counters"]`` holds the deltas over the solve
of the program's counters (``COUNTERS``).

While a profiler runs, each span is also a ``record_function`` range (so a
``--profile`` trace shows the spans over the kernels), and each ``launch``
span records CUDA events at its start and end on the current stream (never
while that stream captures a graph); after the solve's last sync its
``device_ns`` holds their offsets from an event recorded at the root's
start.  With no profiler running only host clocks are read, and no device
sync is added.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import sys
import time
from typing import Dict, List, Optional, Tuple

import torch

from .._device import synchronize

HOST, WAIT, LAUNCH, GROUP = "host", "wait", "launch", "group"

# the program's counters, (module, name): launch counts, host reads,
# captures, projector products; read at a solve's start and end
COUNTERS = (
    ("shm3d_torch.ops.yukawa", "KERNEL_LAUNCHES"),
    ("shm3d_torch.ops.yukawa", "PARTIAL_LAUNCHES"),
    ("shm3d_torch.ops.yukawa", "MERGE_LAUNCHES"),
    ("shm3d_torch.ops.yukawa", "KERNEL_LAUNCHES_F64"),
    ("shm3d_torch.ops.yukawa", "PARTIAL_LAUNCHES_F64"),
    ("shm3d_torch.ops.yukawa", "MERGE_LAUNCHES_F64"),
    ("shm3d_torch.ops.yukawa_skeleton", "KERNEL_LAUNCHES"),
    ("shm3d_torch.solve.pell", "KERNEL_LAUNCHES"),
    ("shm3d_torch.solve.stop", "KERNEL_LAUNCHES"),
    ("shm3d_torch.solve.stop", "START_LAUNCHES"),
    ("shm3d_torch.solve.graphs", "HOST_READS"),
    ("shm3d_torch.solve.graphs", "GRAPH_LAUNCHES"),
    ("shm3d_torch.solve.graphs", "CAPTURES"),
    ("shm3d_torch.solve.projection", "TMAT_PRODUCTS"),
    ("shm3d_torch.solve.projection", "TRI_GEMV_LAUNCHES"),
    ("shm3d_torch.solve.multigrid", "STENCIL_LAUNCHES"),
    ("shm3d_torch.parallel.rows", "ROW_BLOCK_LAUNCHES"),
    ("shm3d_torch.parallel.rows", "BROADCASTS"),
)

# the recorder of the solve running in this context, if any
_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("shm3d_torch_spans", default=None)


_COUNTER_KEYS = tuple((f"{mod}.{name}", mod, name) for mod, name in COUNTERS)


def read_counters() -> Dict[str, int]:
    """``COUNTERS`` as they stand, by qualified name (0 for a module not
    imported yet)."""
    mods = sys.modules
    return {key: getattr(mods.get(mod), name, 0) for key, mod, name in _COUNTER_KEYS}


def profiling() -> bool:
    """A torch profiler is running in this process."""
    return torch._C._autograd._profiler_enabled()


class SpanList(list):
    """``last_stats["spans"]``: its tuples hold immutable values only, so a
    deep copy is a copy of the list (the benchmark copies ``last_stats``
    after every solve)."""

    def __deepcopy__(self, memo):
        return SpanList(self)


class CounterDeltas(dict):
    """``last_stats["counters"]``: ints only, so a deep copy is a copy."""

    def __deepcopy__(self, memo):
        return CounterDeltas(self)


class _NullSpan:
    """What ``span`` and ``tally`` give outside a recorded solve."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


_NULL = _NullSpan()


class _Tally:
    """One span for work repeated under one parent: its start is the first
    occurrence's, its end the last's, ``count`` and ``total_ns`` the
    occurrences and their summed time."""

    __slots__ = ("rec", "name", "kind", "i", "t0", "rf")

    def __init__(self, rec: "PhaseTimer", name: str, kind: str):
        self.rec, self.name, self.kind, self.rf = rec, name, kind, None

    def __enter__(self):
        rec = self.rec
        if rec.profiled:
            self.rf = torch.autograd.profiler.record_function(self.name)
            self.rf.__enter__()
        key = (rec._stack[-1] if rec._stack else -1, self.name)
        i = rec._tallies.get(key)
        self.t0 = time.perf_counter_ns()
        if i is None:
            i = rec._tallies[key] = len(rec._spans)
            rec._spans.append([self.name, key[0], self.kind, self.t0, self.t0,
                               {"count": 0, "total_ns": 0}])
        self.i = i
        return self

    def __exit__(self, *exc):
        s = self.rec._spans[self.i]
        s[4] = time.perf_counter_ns()
        s[5]["count"] += 1
        s[5]["total_ns"] += s[4] - self.t0
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        return False


class _Span:
    """One span of a recorder, opened when entered and closed when left."""

    __slots__ = ("rec", "name", "kind", "attrs", "i")

    def __init__(self, rec: "PhaseTimer", name: str, kind: str, attrs: dict):
        self.rec, self.name, self.kind, self.attrs = rec, name, kind, attrs

    def __enter__(self):
        rec = self.rec
        stack, spans = rec._stack, rec._spans
        self.i = i = len(spans)
        if rec.profiled:
            rec._open_range(i, self.name, self.kind)
        t = time.perf_counter_ns()
        spans.append([self.name, stack[-1] if stack else -1, self.kind, t, t, self.attrs])
        stack.append(i)
        return self

    def __exit__(self, *exc):
        rec = self.rec
        rec._stack.pop()
        s = rec._spans[self.i]
        s[4] = time.perf_counter_ns()
        if rec.profiled:
            rec._close_range(self.i, s[2])
        if rec._out is not None:
            # a span after the solve returned: straight into its list
            rec._out.append(_frozen(s, rec._origin))
        return False

    def set(self, **attrs) -> None:
        """Attributes known only inside the span (iterations)."""
        self.attrs.update(attrs)


class PhaseTimer:
    """The span recorder of one solve: its phases (``phase``, each ending in
    a device sync) and notes.  Spans inside the phases come from the
    module's ``span`` and ``tally``, which find the recorder of the solve
    running in their context."""

    def __init__(self, device: torch.device, verbose: bool = False):
        self.device = device
        self.verbose = verbose
        self.notes: List[str] = []
        self.phases: List[Tuple[str, float]] = []
        # [name, parent, kind, start, end, attrs], perf_counter_ns
        self._spans: list = []
        self._stack: List[int] = []
        self._tallies: dict = {}
        self._origin = time.perf_counter_ns()
        self.profiled = False
        self._ranges: List = []  # the open spans' record_function ranges
        self._pairs: dict = {}   # launch span index -> [start event, end event]
        self._anchor = None
        self._out: Optional[SpanList] = None

    # --- recording

    def _open_range(self, i: int, name: str, kind: str) -> None:
        rf = torch.autograd.profiler.record_function(name)
        rf.__enter__()
        self._ranges.append(rf)
        if kind == LAUNCH and self._anchor is not None:
            self._event(i, 0)

    def _close_range(self, i: int, kind: str) -> None:
        if kind == LAUNCH and i in self._pairs:
            self._event(i, 1)
        self._ranges.pop().__exit__(None, None, None)

    def _event(self, i: int, end: int) -> None:
        """A CUDA event on the current stream at a launch span's start or
        end; none while the stream captures a graph."""
        if torch.cuda.is_current_stream_capturing():
            self._pairs.pop(i, None)
            return
        e = torch.cuda.Event(enable_timing=True)
        e.record(torch.cuda.current_stream(self.device))
        self._pairs.setdefault(i, [None, None])[end] = e

    @contextlib.contextmanager
    def solve(self, stats: dict, name: str = "compute_distance"):
        """The root span of a solve.  On a normal exit ``stats`` gets the
        spans (``"spans"``) and the counters' deltas (``"counters"``); the
        recorder is the one that the module's ``span`` and ``tally`` use
        inside it."""
        self.profiled = profiling()
        before = read_counters()
        if self.profiled and self.device.type == "cuda":
            self._anchor = torch.cuda.Event(enable_timing=True)
            self._anchor.record(torch.cuda.current_stream(self.device))
        token = _ACTIVE.set(self)
        self._origin = time.perf_counter_ns()
        try:
            with _Span(self, name, GROUP, {}):
                yield self
        finally:
            _ACTIVE.reset(token)
        after = read_counters()
        stats["counters"] = CounterDeltas((k, v - before[k]) for k, v in after.items())
        if self._pairs:
            # after the solve's last sync: the launches' device intervals
            synchronize(self.device)
            for i, (e0, e1) in self._pairs.items():
                if e1 is not None:
                    self._spans[i][5]["device_ns"] = (
                        int(self._anchor.elapsed_time(e0) * 1e6),
                        int(self._anchor.elapsed_time(e1) * 1e6))
        self._out = SpanList(_frozen(s, self._origin) for s in self._spans)
        stats["spans"] = self._out

    # --- phases

    @contextlib.contextmanager
    def phase(self, name: str):
        top = _Span(self, name, GROUP, {})
        top.__enter__()
        try:
            yield
        finally:
            with _Span(self, "phase-end sync", WAIT, {}):
                synchronize(self.device)
            top.__exit__()
            s = self._spans[top.i]
            dt = (s[4] - s[3]) / 1e9
            self.phases.append((name, dt))
            if self.verbose:
                print(f"[shm3d_torch] {name}: {dt:.4f} s", file=sys.stderr)

    def note(self, msg: str):
        self.notes.append(msg)
        if self.verbose:
            print(f"[shm3d_torch]   {msg}", file=sys.stderr)

    def as_dict(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, dt in self.phases:
            out[name] = out.get(name, 0.0) + dt
        return out


def _frozen(s: list, origin: int) -> tuple:
    return (s[0], s[1], s[2], s[3] - origin, s[4] - origin, tuple(s[5].items()) if s[5] else ())


def span(name: str, kind: str, **attrs):
    """A span of the solve running in this context (a no-op outside one)."""
    rec = _ACTIVE.get()
    return _NULL if rec is None else _Span(rec, name, kind, attrs)


def after(rec: Optional[PhaseTimer], name: str, kind: str):
    """A span of work for the solve ``rec`` after it returned (the result's
    copy to the host), added to its ``last_stats["spans"]`` (a no-op for
    None or a solve still running)."""
    if rec is None or rec._out is None:
        return _NULL
    return _Span(rec, name, kind, {})


def tally(name: str, kind: str):
    """A tally span of the solve running in this context (a no-op outside
    one)."""
    rec = _ACTIVE.get()
    return _NULL if rec is None else _Tally(rec, name, kind)


@contextlib.contextmanager
def profiler_trace(logdir: Optional[str]):
    """Trace the region with ``torch.profiler`` (host and, where a card is
    visible, CUDA activity) when ``logdir`` is set, and write it there as a
    Chrome trace (``trace.json``; chrome://tracing or Perfetto).  The
    solves' spans show in it as ranges over the kernels."""
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
