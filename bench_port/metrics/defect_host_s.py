"""defect_host_s: the host's compute inside the float64 defect correction a
solve, in seconds: the self time of the program's ``host`` spans under a
span whose name holds "defect correction" (the tet path's f64 residuals
of ``host_op`` and its float64 conversions, the grid's "float64 defect
correction" phase with its host LU solves of the Gram matrix), averaged
over the traced solves.  Left out where no traced solve corrects."""

from harness import spans

UNDER = "defect correction"


def read(run):
    per = spans.of(run.window_stats)
    if per is None or not any(UNDER in x[0] for s in per for x in s):
        return None
    return sum(spans.self_ns(s, spans.HOST, UNDER) for s in per) / len(per) / 1e9
