"""solve_s: the window's wall time over the solves completed in it (the
window ends at the end of the last solve started inside ``--seconds``)."""


def read(run):
    return run.window_s / run.n_solves if run.n_solves else None
