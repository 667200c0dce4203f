"""solve_p95_s: the 95th percentile of the latencies of all the window's
solves (linear interpolation between order statistics)."""

import numpy as np


def read(run):
    return float(np.percentile(run.latencies, 95)) if run.n_solves else None
