"""profiler_cost_pct: how much longer a traced solve takes than an untraced
one in the same run, in percent: the median latency of the traced solves
over the median of the run's untraced warm solves, less one.  The untraced
solves are the set-up's warm solves where the profiler starts after them
(a cell traced from the window), else as many solves as were traced, run
right after the profiler has stopped (a cell traced from before the
captures; on the grid these run 7% slower than a run that never traced,
so the cost there reads low).  The traced run's other device metrics are
read under this cost."""

import statistics


def read(run):
    if run.trace is None or not run.untraced_latencies or not run.latencies:
        return None
    return 100.0 * (statistics.median(run.latencies)
                    / statistics.median(run.untraced_latencies) - 1.0)
