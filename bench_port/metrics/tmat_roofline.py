"""tmat_roofline: the full-row projector's products (``solve.projection``'s
``project_t``: T a, T^T (T a), and the same once more for the Gram
refinement) against HBM at 3.35 TB/s.

Bytes a product are what the inputs need: the lower triangle of the
(m, m) float32 whitening factor T, m (m + 1) / 2 x 4 bytes (T inverts a
lower Cholesky factor, so its strict upper triangle is zero), and the two
(m,) vectors.  m is the number of constraint rows the reference derives.
A projected CG solve projects 4 times in its set-up (b, the start's
matvec and preconditioner, b's M-norm) and twice an iteration, 4 products
a projection; the count comes from the solve's iterations and is held
against the trace's GEMV kernels."""

from harness.device import HBM_BYTES_S
from harness.trace import counted

PATTERN = r"gemv"
PRODUCTS_A_PROJECTION = 4
SETUP_PROJECTIONS = 4
PROJECTIONS_AN_ITERATION = 2


def bytes_a_product(m: int) -> int:
    return 4 * (m * (m + 1) // 2) + 2 * 4 * m


def products(iters: int) -> int:
    return PRODUCTS_A_PROJECTION * (SETUP_PROJECTIONS + PROJECTIONS_AN_ITERATION * int(iters))


def read(run):
    tr = run.trace
    if tr is None:
        return None
    stats = run.window_stats
    if not stats or any(s.get("tier") != "full-row" or s.get("correction_iters")
                        for s in stats):
        return None
    n = sum(products(s["iters"]) for s in stats)
    ev = counted(tr, PATTERN, n, "tmat_roofline", run.notes)
    if ev is None:
        return None
    t = sum(b - a for a, b, _ in ev) / 1e9
    return 100.0 * n * bytes_a_product(run.ref_info["m_rows"]) / HBM_BYTES_S / t
