"""k1_roofline: K1 (``csrc/yukawa.cu``: the partial-sum and merge kernels)
against the SFU bound of the pairs the inputs need.

Pairs a solve: K1's queries (the grid's shell nodes and coarse lattice, or
the tet domain's barycenters, as the reference derives them) times the
sources.  A pair takes MUFU_PER_PAIR MUFU results (an exp2 and a rsqrt);
the card gives 132 SMs x 16 results a clock at its maximum SM clock.  The
time is the kernels' device time in the trace, read only where the trace
holds two events (partial and merge) for each launch the port counted."""

from harness.device import sfu_results_per_s
from harness.trace import counted

PATTERN = r"yukawa_(partial|merge)_kernel"
COUNTER = "shm3d_torch.ops.yukawa.KERNEL_LAUNCHES"
MUFU_PER_PAIR = 2


def pairs_per_solve(queries: int, sources: int) -> int:
    return int(queries) * int(sources)


def bound_s(pairs: float, max_sm_mhz: float) -> float:
    return pairs * MUFU_PER_PAIR / sfu_results_per_s(max_sm_mhz)


def read(run):
    tr = run.trace
    if tr is None or not run.smi.get("clocks.max.sm"):
        return None
    ev = counted(tr, PATTERN, 2 * run.counters.get(COUNTER, 0), "k1_roofline", run.notes)
    if ev is None:
        return None
    t = sum(b - a for a, b, _ in ev) / 1e9
    info = run.ref_info
    if "k1_queries" not in info:
        return None
    pairs = pairs_per_solve(info["k1_queries"], info["n_sources"]) * tr.n_solves
    return 100.0 * bound_s(pairs, float(run.smi["clocks.max.sm"])) / t
