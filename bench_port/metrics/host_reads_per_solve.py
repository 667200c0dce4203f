"""host_reads_per_solve: the host's reads of the Krylov stop state
(``shm3d_torch.solve.graphs.HOST_READS``) over the solves read."""

COUNTER = "shm3d_torch.solve.graphs.HOST_READS"


def read(run):
    if not run.n_solves or COUNTER not in run.counters:
        return None
    return run.counters[COUNTER] / run.n_solves
