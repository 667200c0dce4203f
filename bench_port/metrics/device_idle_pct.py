"""device_idle_pct: 100 minus the share of the traced solves' wall span
(marker to marker) that the union of the device's activity intervals
(kernels, copies, fills, and where the graphs are timed by events, their
launches whole) covers.  Left out where the trace misses the graphs'
kernels and nothing timed them."""


def read(run):
    tr = run.trace
    if tr is None or tr.window_ns <= 0 or not tr.complete:
        return None
    return 100.0 * (1.0 - tr.busy_ns() / tr.window_ns)
