"""host_work_s: the host's own compute a solve, in seconds: the summed self
time of the program's ``host`` spans (``last_stats["spans"]``: SciPy and
NumPy work, hashing, host LU solves, float64 conversions; a span's self
time is its interval less its children's, a tally's its total), averaged
over the traced solves.  Left out where the program records no spans."""

from harness import spans


def read(run):
    per = spans.of(run.window_stats)
    if per is None:
        return None
    return sum(spans.self_ns(s, spans.HOST) for s in per) / len(per) / 1e9
