"""launch_calls_per_solve: the host's kernel launch calls
(``cudaLaunchKernel``, ``cuLaunchKernel``) in the traced solves, from the
trace's runtime events, over the solves; graph launches are not kernel
launch calls."""


def read(run):
    tr = run.trace
    if tr is None or tr.n_solves == 0:
        return None
    return tr.launch_calls() / tr.n_solves
