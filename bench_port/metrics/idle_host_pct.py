"""idle_host_pct: the share of the traced solves' wall span (marker kernel
to marker kernel) in which the device is idle while the host computes
inside one of the program's ``host`` spans, in percent.

Each solve's spans are placed at its marker's start plus their offsets
(the solve's root span starts right after the marker).  The device is
busy where the trace holds a device event or where one of the program's
``launch`` spans ran on the device (its CUDA events, recorded while the
profiler runs; a chunk graph's launch counts busy whole), so the share is
at most ``device_idle_pct``.  Left out where the program records no
spans."""

from harness import spans


def read(run):
    tr = run.trace
    if tr is None or tr.window_ns <= 0:
        return None
    per = spans.of(run.window_stats)
    if per is None or len(per) != tr.n_solves:
        return None
    busy = [(a, b) for a, b, _ in tr.device]
    pieces = []
    for (s0, _), s in zip(tr.solves, per):
        busy += [(s0 + a, s0 + b) for a, b in spans.device_intervals(s)]
        pieces += [(s0 + a, s0 + b, w) for a, b, w in spans.self_pieces(s, spans.HOST)]
    return 100.0 * spans.idle_overlap_ns(pieces, busy, *tr.span) / tr.window_ns
