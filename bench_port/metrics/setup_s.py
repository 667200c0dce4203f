"""setup_s: from the first statement of ``run.py`` to the window's start:
imports, the kernel build (from the checkout's build directory after its
first run), the inputs, the cold solve (host precompute, upload, graph
captures) and the warm-up solves."""


def read(run):
    return run.setup_s
