#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (shm3d_torch) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

1. prints the card (nvidia-smi name and power limit);
2. builds the CUDA kernels from shm3d_torch/csrc with nvcc (sm_90a);
3. checks the Yukawa kernel (chunked partial sums and their merge) against
   its plain PyTorch version on the card (ragged shapes, a query on a
   source, far queries with a large lambda), printing the source chunks
   each launch splits into;
4. drives the main path through the public API: the grid-domain exact
   solve of a 52,290-point oriented sphere cloud on a 128^3 grid
   (h_coef=3), float32, refine_steps=0 -- one cold and three warm solves --
   counting the kernel launches it makes;
5. checks phi (finite, right shape, rel-L2 against the analytic signed
   distance |x| - 1 within 10% of the JAX package's on the same input) and
   the kernel against the plain version on the main path's own shell
   queries and on its whole coarse launch (every row finite and of unit
   norm, the far ones too), timing both at the main path's shapes;
6. checks the sliced-ELL SpMV kernel against its plain PyTorch version on
   the card (the device form of random, multiplicity and forced-segment
   paged operators, one launch a matvec);
7. drives the tet path through the public API: tests/data/knot_dec.obj at
   the library's default options (conforming tet domain, Crouzeix-Raviart
   face solve over the face operator, paged on the host and sliced ELL on
   the card, float32 with f64 defect correction) -- one cold and three warm
   solves -- counting both kernels' launches, checks phi against the JAX
   package's numbers on the same input, and holds each kernel against its
   plain version at the tet path's own shapes (the Yukawa kernel at the tet
   barycenters, the sliced-ELL kernel on the solve's face operator), timing
   both, and times the sliced-ELL kernel against its bounds (slot and
   useful bytes over the measured memory ceiling) and against one cuSPARSE
   CSR product of the same operator (a yardstick only), with the paged
   layout's bytes and the upload's conversion time beside them;
8. drives the grid domain's default tier on the main path's input
   (float32 solve with float64 defect correction, refine_steps=1) -- one
   cold and three warm solves and a reference solve refined to 1e-11 --
   and checks the fast tier's rel-L2 against that reference (<= 1e-5), the
   correction's residual, that refinement adds no Yukawa launches, and that
   the four solves give one phi bit for bit;
9. the roofline phase: the Yukawa speed-of-light probe (K3) against its
   plain version, then K3 and the Yukawa kernel at bench_kernels.py's three
   shapes and at the main path's two launch shapes, each against the SFU
   bound (two MUFU operations a pair at the card's SM clock), and a 1 GiB
   float32 triad as the measured memory ceiling.  K3's time over K1's
   (``pct_of_skeleton``) is a ratio of two kernels, not a share of a bound,
   and exceeds 100% where K1 is the faster.

Every kernel's launch count is set to 0 just before the path that runs it
and read just after.  The last two lines of standard output are a JSON
summary of the kernels and the JSON status line; the card's name and power
limit come before them.  Any failed check exits non-zero before them; so
does a machine without CUDA, and a directory without the repository.
"""

import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))

N_POINTS = 52290  # SprayBottle.pc's point count, on a sphere
H_COEF = 3.0      # 128^3 grid
# rel-L2 of phi against |x| - 1 for this exact input, measured with the JAX
# package (shm3d.solvers.grid.GridSolver, float32, refine_steps=0, CPU)
JAX_ANALYTIC_REL_L2 = 0.008774947261797708
ANALYTIC_BAND = 0.10
# Kernel vs plain version, both float32 on the card.  The sums run in
# another order (source chunks merged, a reference moved once a stage, vs
# one minimum per query tile), so unit directions differ at the 1e-6 level
# where |X| does not cancel; the test inputs keep |X| away from
# cancellation (shell nodes, +z-biased vectors).
DIR_TOL = 1e-4    # max abs error, normalized directions
RAW_RTOL = 1e-4   # max abs error / max |X|, unnormalized sums
SAMPLE_ROWS = 65536

# tet phase: tests/data/knot_dec.obj at SignedHeatOptions() defaults.  The
# JAX package on the same input (shm3d.tet.solver.SignedHeatTetSolver, CPU,
# float32): the conforming mesh, the paged face operator, and phi
KNOT = os.path.join(REPO, "tests", "data", "knot_dec.obj")
KNOT_VERTICES = 198814
KNOT_FACES = 2245964
KNOT_L_NNZ = 15608852
JAX_KNOT_PASSES = 97280        # with the TPU build's compile-shape padding
JAX_PHI_MIN = -25.49828
JAX_PHI_MAX = 145.07733
JAX_PHI_MEAN_ABS = 55.45258
JAX_PHI_MEAN_ABS_SRC = 0.74078
JAX_FACE_RESIDUAL = 2.209e-4   # final f64 relative residual, face solve
JAX_PROJ_RESIDUAL = 2.707e-10
# relative bands on the phi statistics.  The port's float32 solve on the
# H100 read 9.2e-4 (min), 4.1e-7 (max), 5.8e-6 (mean |phi|) and 7.8e-6
# (mean |phi| at the sources) off these numbers; the minimum, a single
# interior value, moves most with where float32 CG stops (up to 1.4e-3
# under other summation orders, the other three up to 2.3e-5)
PHI_BANDS = dict(min=1e-2, max=1e-4, mean_abs=1e-4, src_mean_abs=1e-4)
FACE_RESIDUAL_MAX = 1e-3
PROJ_RESIDUAL_MAX = 1e-8
# sliced-ELL kernel vs plain version, float32 on the card: the same products
# summed in the same order, fused in the kernel
PELL_RTOL = 1e-5               # max abs error / max |y|
# the same solve with the paged-ELL kernel that the sliced-ELL one replaced:
# 229 face iterations, final f64 face residual 6.528e-4
PAGED_FACE_ITERS, PAGED_FACE_RESIDUAL = 229, 6.528e-4

# default tier on the main path's input.  The JAX package on the same input
# (shm3d.solvers.grid.GridSolver, CPU, JAX x64 off, so float32 solves with
# two-float residuals, as on the TPU): rel-L2 of each tier against the
# solve refined to 1e-11, and the default tier's per-pass f64 residuals
JAX_REL_L2_FAST_TIER = 1.0620449766978294e-06
JAX_REL_L2_DEFAULT_TIER = 3.324839665958726e-10
JAX_DEFAULT_PASS_RELS = [7.832e-05, 6.361e-07, 5.852e-09, 3.409e-11]
FAST_TIER_REL_L2_MAX = 1e-5    # the reference's accuracy bar (BASELINE.md)

# roofline phase: bench_kernels.py's shapes (queries, sources), lambda 4
ROOFLINE_SHAPES = ((1 << 19, 52290), (1 << 20, 52290), (1 << 20, 8192))
ROOFLINE_LAM = 4.0
SKELETON_RTOL = 1e-5           # max |kernel - plain| / row sum
# far from every source a row's terms underflow in float32 (the probe has no
# running minimum): there both versions give 0, and the error is taken
# relative to this floor instead
ROW_SUM_FLOOR = 1e-30
SMS, MUFU_PER_CLK = 132, 16    # H100 SXM: SMs, special-function results/clk/SM
MUFU_PER_PAIR = 2              # rsqrt and the exponential's ex2
HBM_BYTES_S = 3.35e12          # published H100 SXM memory rate
FP32_FLOPS_S = 67e12           # published H100 SXM float32 rate (no tensor cores)
TRIAD_FLOATS = 1 << 28         # 1 GiB of float32 per operand


def check(ok: bool, what: str) -> None:
    if not ok:
        print(f"FAILED: {what}", file=sys.stderr, flush=True)
        sys.exit(1)


def check_no_jax_package() -> None:
    check("jax" not in sys.modules, "JAX was never imported")
    bad = sorted(m for m in sys.modules if m == "shm3d" or m.startswith("shm3d."))
    check(not bad, f"no module of the JAX package was imported ({bad[:5]})")


def smi_query(field: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={field}", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]


def row_rel_err(got, ref) -> float:
    """max |got - ref| / row sum, the row sum floored at ROW_SUM_FLOOR."""
    return ((got - ref).abs() / ref.clamp_min(ROW_SUM_FLOOR)).max().item()


def sfu_pairs_per_s() -> float:
    """The SFU bound of a Yukawa pair: SMS x MUFU_PER_CLK results a clock at
    the card's maximum SM clock, MUFU_PER_PAIR results a pair."""
    mhz = float(smi_query("clocks.max.sm"))
    return SMS * MUFU_PER_CLK * mhz * 1e6 / MUFU_PER_PAIR


def pair_bound_ms(pairs: float, queries: int, sources: int, sfu: float,
                  out_floats: int = 3, src_floats: int = 6) -> float:
    """Least time of a Yukawa-type launch: the larger of its SFU time and
    its bytes (queries and outputs once, sources once) over HBM_BYTES_S."""
    nbytes = 4 * (queries * (3 + out_floats) + sources * src_floats)
    return max(pairs / sfu, nbytes / HBM_BYTES_S) * 1e3


def time_ms(fn, reps: int) -> float:
    """Mean device time of fn() over ``reps`` runs after one warm-up."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def chunks(yk, q, p) -> str:
    """The source split of the Yukawa kernel's launch on these shapes."""
    Q, S = int(q.shape[0]), int(p.shape[0])
    n = yk.yukawa_chunk_len(Q, S, q.device)
    return f"{-(-S // n)} chunks of {n} sources x {-(-Q // 1024)} query blocks"


def profile_solve(label, fn, warm_s, smi, names=("sell_kernel", "yukawa_partial", "yukawa_merge")):
    """One solve under torch.profiler, after one profiled warm-up (the
    profiler's own start-up): the device time of its kernels (kernel events
    only: an operator's row repeats its kernels' time), its wall time, the
    kernels that took most device time, and the device time of the kernels
    whose names contain ``names``.  ``warm_s``: the unprofiled warm solve's
    wall time, which the kernels' time is also held against."""
    from torch.profiler import ProfilerActivity, profile

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA") and dev_us(e) > 0]
    total_ms = sum(dev_us(e) for e in kernels) / 1e3
    kernels.sort(key=dev_us, reverse=True)
    top = ", ".join(f"{e.key[:40]} {dev_us(e) / 1e3:.1f} ms x{e.count}" for e in kernels[:6])
    ours = ", ".join(f"{n} {sum(dev_us(e) for e in kernels if n in e.key) / 1e3:.2f} ms "
                     f"x{sum(e.count for e in kernels if n in e.key)}" for n in names)
    print(f"  profiled {label}: {total_ms:.1f} ms of kernel time in "
          f"{sum(e.count for e in kernels)} launches, {wall_ms:.1f} ms of wall time "
          f"under the profiler (busy {total_ms / wall_ms:.1%}; {total_ms / 1e3 / warm_s:.1%} "
          f"of the unprofiled warm median {warm_s:.4f} s); {ours}; top: {top} ({smi})")


def compare(yk, q, p, v, lam, normalize):
    """(max abs error, kernel output) of kernel vs plain on one input."""
    got = yk.yukawa_field_cuda(q, p, v, lam, normalize=normalize)
    ref = yk.yukawa_field_torch(q, p, v, lam, normalize=normalize)
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    if not normalize:
        err /= ref.abs().max().item()
    return err, got


def kernel_cases(yk, dev):
    """Seeded ragged, coincident and far inputs; each checked and printed."""
    rng = np.random.default_rng(0)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32, device=dev)

    q = rng.uniform(-1, 1, (5003, 3))
    p = rng.uniform(-1, 1, (4099, 3))
    v = rng.normal(size=(4099, 3)) * 0.3
    v[:, 2] += 1.0
    for normalize in (True, False):
        err, got = compare(yk, t(q), t(p), t(v), 7.5, normalize)
        tol = DIR_TOL if normalize else RAW_RTOL
        print(f"kernel vs plain  ragged Q=5003 S=4099 normalize={normalize}: "
              f"max err {err:.3e} (tol {tol:g}; {chunks(yk, t(q), t(p))})")
        check(bool(torch.isfinite(got).all()), "ragged case finite")
        check(err <= tol, "ragged case within tolerance")

    # sphere sources with outward normals; queries on sources and far away
    n = rng.normal(size=(3001, 3))
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    sp, sv = t(n), t(n * rng.uniform(0.5, 1.5, (3001, 1)))
    on = t(n[:257])
    err, got = compare(yk, on, sp, sv, 10.0, True)
    check(bool(torch.isfinite(got).all()), "coincident queries finite")
    unit = (torch.linalg.vector_norm(got, dim=1) - 1).abs().max().item()
    print(f"kernel vs plain  coincident Q=257 S=3001: max err {err:.3e} "
          f"(tol {DIR_TOL:g}), | |Y|-1 | <= {unit:.1e} ({chunks(yk, on, sp)})")
    check(err <= DIR_TOL and unit <= 1e-5, "coincident case")

    far = rng.normal(size=(1000, 3))
    far = t(40.0 * far / np.linalg.norm(far, axis=1, keepdims=True))
    underflow = float(np.exp(np.float32(-50.0 * 39.0)))
    err, got = compare(yk, far, sp, sv, 50.0, True)
    check(bool(torch.isfinite(got).all()), "far queries finite")
    unit = (torch.linalg.vector_norm(got, dim=1) - 1).abs().max().item()
    print(f"kernel vs plain  far |q|=40 lam=50 (unscaled exp -> {underflow}): "
          f"max err {err:.3e} (tol {DIR_TOL:g}), | |Y|-1 | <= {unit:.1e} "
          f"({chunks(yk, far, sp)})")
    check(err <= DIR_TOL and unit <= 1e-5, "far case within tolerance, unit rows")


def sell_compare(pell, S, x):
    """(max abs error, max abs error / max |y|) of the sliced-ELL kernel vs
    its plain version; the kernel must launch once."""
    before = pell.KERNEL_LAUNCHES
    got = pell.sell_matvec_cuda(S, x)
    check(pell.KERNEL_LAUNCHES == before + 1, "one sliced-ELL launch a matvec")
    ref = pell.sell_matvec_torch(S, x)
    torch.cuda.synchronize()
    check(got.shape == ref.shape and bool(torch.isfinite(got).all()),
          "sliced-ELL kernel output shape and finiteness")
    err = (got - ref).abs().max().item()
    return err, err / max(ref.abs().max().item(), 1e-30)


def sell_cases(pell, ell, dev):
    """The device form (sliced ELL) of seeded random, multiplicity and
    forced-segment paged operators; each checked and printed."""
    import scipy.sparse as sp

    rng = np.random.default_rng(2)

    def banded(n, per_row, half):
        rows = np.repeat(np.arange(n), per_row)
        cols = (rows + rng.integers(-half, half + 1, rows.size)) % n
        return sp.coo_matrix((rng.standard_normal(rows.size), (rows, cols)),
                             shape=(n, n)).tocsr()

    n, m, nnz = 100_003, 90_001, 1_000_000
    random = sp.coo_matrix((rng.standard_normal(nnz), (rng.integers(0, n, nnz),
                                                       rng.integers(0, m, nnz))),
                           shape=(n, m)).tocsr()
    cases = [("random 100003x90001", random, None),
             ("multiplicity", banded(300_000, 9, 40), None),
             ("forced segments", banded(11 * pell.PAGE + 5, 4, 600), 26)]
    for name, A, seg_passes in cases:
        saved = pell._SEG_PASSES
        if seg_passes:
            pell._SEG_PASSES = seg_passes
        try:
            P = pell.build_paged(A, np.float32)
        finally:
            pell._SEG_PASSES = saved
        S = ell.device_put_tree(P, dev)
        check(isinstance(S, pell.SellMat) and S.nnz == A.nnz, f"{name} uploaded as sliced ELL")
        x = torch.as_tensor(rng.standard_normal(A.shape[1]), dtype=torch.float32,
                            device=dev)
        err, rel = sell_compare(pell, S, x)
        print(f"sliced-ELL kernel vs plain  {name}: {P.n_passes} passes in "
              f"{len(P.segs)} segments on the host, {S.n_slices} slices of "
              f"{S.n_slots} slots on the card, max err {err:.3e}, relative "
              f"{rel:.3e} (tol {PELL_RTOL:g})")
        check(rel <= PELL_RTOL, f"sliced-ELL kernel {name} within tolerance")


def tet_phase(smi, dev, ceiling):
    """The tet path on knot_dec; returns (the Yukawa kernel's tet-path
    numbers, the sell_matvec entry of the kernels line).  ``ceiling`` is
    the measured memory rate (bytes/s) the sliced-ELL kernel is held
    against."""
    from shm3d_torch.io.mesh_io import read_geometry
    from shm3d_torch import SignedHeatOptions, SignedHeatSolver
    from shm3d_torch.ops import yukawa as yk
    from shm3d_torch.solve import pell

    geom = read_geometry(KNOT)
    opts = SignedHeatOptions(disk_cache=False)
    solver = SignedHeatSolver("tet", device=dev)
    runs = []
    yk.KERNEL_LAUNCHES = 0
    pell.KERNEL_LAUNCHES = 0
    for k in range(4):
        before = pell.KERNEL_LAUNCHES
        t0 = time.perf_counter()
        res = solver.compute_distance(geom, opts)
        torch.cuda.synchronize()
        runs.append(dict(s=time.perf_counter() - t0, k2=pell.KERNEL_LAUNCHES - before,
                         stats=dict(solver.last_stats)))
    k1_launches, k2_launches = yk.KERNEL_LAUNCHES, pell.KERNEL_LAUNCHES
    cached = next(iter(solver._impl._cache.values()))
    cr = cached["cr_path"]
    L = cr.arrays["L"]
    stats = runs[-1]["stats"]
    warm = [r["s"] for r in runs[1:]]
    # the host form of the same operator (prepare's build_paged of the
    # Morton-ordered face operator) and the upload's conversion of it
    P = pell.build_paged(cr._H, np.float32)
    t0 = time.perf_counter()
    P_sell = pell.to_sell(P)
    convert_s = time.perf_counter() - t0
    check(np.array_equal(P_sell.cols, L.cols.cpu().numpy())
          and np.array_equal(P_sell.vals, L.vals.cpu().numpy()),
          "the solve's face operator is the upload of its paged form")
    paged_bytes = P.n_passes * pell.PAGE * 8
    sell_bytes = L.n_slots * 8 + 8 * (L.n_slices + 1)
    # the CSR stores explicit zeros; neither layout keeps them (the paged
    # kernel skipped them, the conversion drops them)
    nonzeros = int(np.count_nonzero(cr._H.data.astype(np.float32)))
    print(f"tet path: knot_dec.obj, {len(geom.faces)} input faces, default "
          f"options (ZERO_SET, CR, float32, refine_steps=1), disk_cache=False")
    print(f"  mesh: {res.mesh.n_vertices} vertices, {res.mesh.n_tets} tets, "
          f"{res.mesh.n_faces} faces, conforming {res.mesh.conforming}")
    print(f"  face operator: nnz {P.nnz} in the CSR, {nonzeros} of them nonzero; "
          f"{type(L).__name__} on the card with {L.nnz} entries in "
          f"{L.n_slices} slices, {L.n_slots} slots ({L.nnz / L.n_slots:.1%} "
          f"filled), {sell_bytes / 1e6:.1f} MB; paged on the host: {P.n_passes} "
          f"passes in {len(P.segs)} segments (JAX package: {JAX_KNOT_PASSES} with "
          f"its compile-shape padding), {paged_bytes / 1e6:.1f} MB of values and "
          f"indices; conversion to sliced ELL {convert_s:.3f} s on the host; amg "
          f"sizes {stats['amg_sizes']}")
    print(f"  cold solve {runs[0]['s']:.3f} s, mem_peak_mb "
          f"{runs[0]['stats']['mem_peak_mb']:.1f}, phases "
          f"{json.dumps(runs[0]['stats']['phases'])}")
    print(f"  warm solves {[round(w, 4) for w in warm]} s, median "
          f"{statistics.median(warm):.4f} s, mem_peak_mb {stats['mem_peak_mb']:.1f}, "
          f"phases {json.dumps(stats['phases'])}")
    for k, r in enumerate(runs):
        st = r["stats"]
        print(f"  solve {k}: {r['s']:.3f} s, sliced-ELL kernel launches {r['k2']}, "
              f"face iters {st['iters']} (chunks {st['chunks']}), f64 residual "
              f"passes {st['refine_pass_rels']}, projection iters {st['proj_iters']}, "
              f"residual passes {st['proj_refine_pass_rels']}")
    print(f"  face iterations {stats['iters']}, final f64 face residual "
          f"{stats['residual']:.3e} (the paged kernel's solve: {PAGED_FACE_ITERS}, "
          f"{PAGED_FACE_RESIDUAL:.3e}); warm median {statistics.median(warm) / stats['iters'] * 1e3:.2f} "
          f"ms a face iteration")
    print(f"  kernel launches in the 4 solves: yukawa {k1_launches}, sliced ELL "
          f"{k2_launches}")
    check(k1_launches > 0, "the tet path launched the Yukawa kernel")
    check(len({(r["stats"]["iters"], tuple(r["stats"]["refine_pass_rels"]))
               for r in runs}) == 1, "the four tet solves repeat bit for bit")
    check(all(r["k2"] > 0 for r in runs), "every tet solve launched the sliced-ELL kernel")
    check(all(r["stats"]["step3_path"] == "crouzeix-raviart" for r in runs),
          "step 3 took the Crouzeix-Raviart path")
    check(isinstance(L, pell.SellMat) and P.nnz == KNOT_L_NNZ and L.nnz == nonzeros,
          f"face operator of nnz {KNOT_L_NNZ} in sliced ELL with its {nonzeros} nonzeros")
    check(res.mesh.n_faces == KNOT_FACES, "conforming mesh face count")

    phi = res.phi
    check(phi.shape == (KNOT_VERTICES,), "phi shape")
    check(bool(np.isfinite(phi).all()), "phi finite")
    got = dict(min=float(phi.min()), max=float(phi.max()),
               mean_abs=float(np.abs(phi).mean()),
               src_mean_abs=float(np.abs(res.phi_at_sources()).mean()))
    print(f"  phi min {got['min']:.5f} max {got['max']:.5f} mean|phi| "
          f"{got['mean_abs']:.5f}, mean|phi| at the sources {got['src_mean_abs']:.5f} "
          f"(JAX package: {JAX_PHI_MIN} / {JAX_PHI_MAX} / {JAX_PHI_MEAN_ABS} / "
          f"{JAX_PHI_MEAN_ABS_SRC})")
    print(f"  final f64 residuals: face {stats['residual']:.3e} (limit "
          f"{FACE_RESIDUAL_MAX:g}; JAX {JAX_FACE_RESIDUAL:g}), projection "
          f"{stats['proj_residual']:.3e} (limit {PROJ_RESIDUAL_MAX:g}; JAX "
          f"{JAX_PROJ_RESIDUAL:g})")
    for r in runs:
        check(r["stats"]["residual"] <= FACE_RESIDUAL_MAX, "face residual")
        check(r["stats"]["proj_residual"] <= PROJ_RESIDUAL_MAX, "projection residual")
    for name, ref in (("min", JAX_PHI_MIN), ("max", JAX_PHI_MAX),
                      ("mean_abs", JAX_PHI_MEAN_ABS),
                      ("src_mean_abs", JAX_PHI_MEAN_ABS_SRC)):
        band, limit = abs(got[name] - ref) / abs(ref), PHI_BANDS[name]
        print(f"  phi {name}: off the JAX package's by {band:.3e} (limit {limit:g})")
        check(band <= limit, f"phi {name} within {limit:g} of the JAX package")

    # the Yukawa kernel at the tet path's own shapes: every tet barycenter
    q, pts, vecs = cached["barys"], cached["points"], cached["vectors"]
    lam = float(np.sqrt(1.0 / (opts.t_coef * cached["spacing"] ** 2)))
    k1_err, _ = compare(yk, q, pts, vecs, lam, True)
    print(f"kernel vs plain  tet-path barycenters Q={q.shape[0]} S={pts.shape[0]}: "
          f"max err {k1_err:.3e} (tol {DIR_TOL:g})")
    check(k1_err <= DIR_TOL, "Yukawa kernel at the tet barycenters within tolerance")
    k1_ms = time_ms(lambda: yk.yukawa_field_cuda(q, pts, vecs, lam), 20)
    k1_plain_ms = time_ms(lambda: yk.yukawa_field_torch(q, pts, vecs, lam), 3)
    print(f"  yukawa kernel {k1_ms:.3f} ms, plain {k1_plain_ms:.3f} ms at the tet "
          f"barycenters (1 launch per solve; {smi})")

    # the kernel at the solve's own face operator
    x = torch.as_tensor(np.random.default_rng(3).standard_normal(L.n_cols),
                        dtype=torch.float32, device=dev)
    err, rel = sell_compare(pell, L, x)
    print(f"sliced-ELL kernel vs plain  main-path face operator: max err {err:.3e}, "
          f"relative {rel:.3e} (tol {PELL_RTOL:g})")
    check(rel <= PELL_RTOL, "sliced-ELL kernel on the face operator within tolerance")
    t_plain = time_ms(lambda: pell.sell_matvec_torch(L, x), 5)

    # the one library call that computes the same y = L x: cuSPARSE CSR SpMV
    H = cr._H
    Acsr = torch.sparse_csr_tensor(
        torch.as_tensor(H.indptr, dtype=torch.int32, device=dev),
        torch.as_tensor(H.indices, dtype=torch.int32, device=dev),
        torch.as_tensor(H.data, dtype=torch.float32, device=dev), size=H.shape)
    y_lib = Acsr @ x
    y_ref = pell.sell_matvec_torch(L, x)
    lib_rel = ((y_lib - y_ref).abs().max() / y_ref.abs().max()).item()
    # turns: kernel, library, library, kernel
    t_k, t_l = [], []
    for _ in range(2):
        t_k.append(time_ms(lambda: pell.sell_matvec_cuda(L, x), 50))
        t_l.append(time_ms(lambda: Acsr @ x, 50))
        t_l.append(time_ms(lambda: Acsr @ x, 50))
        t_k.append(time_ms(lambda: pell.sell_matvec_cuda(L, x), 50))
    t_kernel, t_lib = statistics.median(t_k), statistics.median(t_l)
    print(f"  cuSPARSE CSR SpMV of the same operator (yardstick, not on any "
          f"path): {t_lib:.4f} ms (turns {[round(t, 4) for t in t_l]}), relative "
          f"difference {lib_rel:.2e}; the sliced-ELL kernel {t_kernel:.4f} ms (turns "
          f"{[round(t, 4) for t in t_k]}), {t_kernel / t_lib:.2f}x the library's "
          f"time; plain {t_plain:.3f} ms ({smi})")
    check(lib_rel <= PELL_RTOL, "cuSPARSE product agrees with the plain version")
    per_solve = [r["k2"] for r in runs]
    print(f"  sliced-ELL launches per solve {per_solve}; per face CG iteration "
          f"{per_solve[-1] / max(stats['iters'], 1):.2f}; {per_solve[-1] * t_kernel:.1f} "
          f"ms of kernel time per solve if every launch took the face operator's")
    # bounds: the bytes the product needs (each nonzero's value and column
    # once, x and y once; the kernel's bound), the same counted over the
    # CSR's stored entries, the sliced layout's (every slot) and the paged
    # layout's, over the measured ceiling and the published rate
    xy = 4 * (L.n_cols + L.n_rows)
    useful = 8 * nonzeros + xy
    bound_ms = useful / HBM_BYTES_S * 1e3
    for name, nbytes in (("useful", useful), ("stored-nnz", 8 * P.nnz + xy),
                         ("slot", sell_bytes + xy), ("paged-layout", paged_bytes + xy)):
        at_ceiling, at_peak = nbytes / ceiling * 1e3, nbytes / HBM_BYTES_S * 1e3
        print(f"  {name} bytes {nbytes / 1e9:.4f} GB: {at_ceiling:.4f} ms at the "
              f"measured ceiling ({at_ceiling / t_kernel:.1%} of the kernel's time), "
              f"{at_peak:.4f} ms at 3.35 TB/s ({at_peak / t_kernel:.1%})")
    profile_solve("warm tet solve", lambda: solver.compute_distance(geom, opts),
                  statistics.median(warm), smi)
    k1 = dict(launches=k1_launches, max_abs_err=k1_err, ms=k1_ms, plain_ms=k1_plain_ms,
              pairs=int(q.shape[0]) * int(pts.shape[0]), queries=int(q.shape[0]),
              sources=int(pts.shape[0]))
    return k1, {
        "name": "sell_matvec",
        "route": "cuda",
        "source": "shm3d_torch/csrc/pell.cu",
        "replaces": "shm3d/solve/pell.py:335",
        "launches": k2_launches,
        "max_abs_err": err,
        "ms": t_kernel,
        "plain_ms": t_plain,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": t_lib,
    }


def default_tier_phase(solver, geom, opts, phi_fast, yk, smi):
    """The grid domain's default tier on the main path's input, with the
    protocol of bench.py's accuracy block: one cold and three warm solves
    at refine_steps=1, then a solve refined to 1e-11 as the reference."""
    opts1 = opts.with_(refine_steps=1)
    print(f"default tier: the main path's input at refine_steps=1, refine_mode="
          f"{opts1.refine_mode!r}, refine_target {opts1.refine_target:g} (the "
          f"fast tier's discretization, so the first solve is cold only in "
          f"the refinement: the host Gram factor)")
    runs = []
    yk.KERNEL_LAUNCHES = 0
    for k in range(4):
        before = yk.KERNEL_LAUNCHES
        t0 = time.perf_counter()
        res1 = solver.compute_distance(geom, opts1)
        torch.cuda.synchronize()
        runs.append(dict(s=time.perf_counter() - t0, k1=yk.KERNEL_LAUNCHES - before,
                         stats=dict(solver.last_stats),
                         phi=hashlib.sha1(res1.phi.tobytes()).hexdigest()))
    k1_default = yk.KERNEL_LAUNCHES
    phi1 = res1.phi
    before = yk.KERNEL_LAUNCHES
    t0 = time.perf_counter()
    res_ref = solver.compute_distance(
        geom, opts.with_(refine_steps=10, refine_target=1e-11))
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    ref_stats = dict(solver.last_stats)
    ref_k1 = yk.KERNEL_LAUNCHES - before
    phi_ref = res_ref.phi
    nrm = float(np.linalg.norm(phi_ref))
    rel_fast = float(np.linalg.norm(phi_fast - phi_ref)) / nrm
    rel_default = float(np.linalg.norm(phi1 - phi_ref)) / nrm
    for k, r in enumerate(runs):
        st = r["stats"]
        print(f"  solve {k} ({'cold' if k == 0 else 'warm'}): {r['s']:.4f} s, yukawa "
              f"launches {r['k1']}, refine_pass_rels {st.get('refine_pass_rels')}, "
              f"refine_rel_res {st.get('refine_rel_res')}, correction_iters "
              f"{st.get('correction_iters')}, refine_detail {st.get('refine_detail')}, "
              f"phases {json.dumps(st['phases'])}")
    warm = [r["s"] for r in runs[1:]]
    print(f"  warm default-tier solves {[round(w, 4) for w in warm]} s, median "
          f"{statistics.median(warm):.4f} s ({smi})")
    print(f"  reference solve (refine_steps=10, refine_target=1e-11): {ref_s:.3f} s, "
          f"refine_pass_rels {ref_stats.get('refine_pass_rels')}, refine_rel_res "
          f"{ref_stats.get('refine_rel_res')}, correction_iters "
          f"{ref_stats.get('correction_iters')}, yukawa launches {ref_k1}")
    print(f"  rel_l2_fast_tier {rel_fast:.6e} (limit {FAST_TIER_REL_L2_MAX:g}; JAX "
          f"package, same input: {JAX_REL_L2_FAST_TIER:.6e})")
    print(f"  rel_l2_default_tier {rel_default:.6e} (JAX package, same input: "
          f"{JAX_REL_L2_DEFAULT_TIER:.6e}; its passes {JAX_DEFAULT_PASS_RELS})")
    distinct = len({r["phi"] for r in runs})
    print(f"  yukawa kernel launches in the 4 default-tier solves: {k1_default}; "
          f"distinct phi among them: {distinct}")
    check(distinct == 1, "the four default-tier solves give one phi bit for bit")
    stats = runs[-1]["stats"]
    check(rel_fast <= FAST_TIER_REL_L2_MAX, "fast tier within 1e-5 of the refined reference")
    check(all("refine_skipped" not in r["stats"] for r in runs)
          and "refine_skipped" not in ref_stats, "no solve skipped the refinement")
    check(all(r["stats"]["refine_rel_res"] <= r["stats"]["refine_pass_rels"][0]
              for r in runs), "the default tier's residual is at most the fast tier's defect")
    check(all(r["k1"] == 2 for r in runs) and ref_k1 == 2,
          "refinement adds no Yukawa launches (2 per solve)")
    check(bool(np.isfinite(phi1).all()) and phi1.shape == phi_fast.shape,
          "default-tier phi finite, of the fast tier's shape")
    return dict(rel_l2_fast_tier=rel_fast, rel_l2_default_tier=rel_default,
                refine_rel_res=stats["refine_rel_res"],
                warm_median_s=statistics.median(warm))


def hbm_ceiling(dev, smi) -> float:
    """Measured memory ceiling: a = b + s c over 1 GiB float32 operands
    (two reads and one write a float), plain torch, a measurement only."""
    a, b, c = (torch.empty(TRIAD_FLOATS, dtype=torch.float32, device=dev) for _ in range(3))
    b.uniform_()
    c.uniform_()
    t = time_ms(lambda: torch.add(b, c, alpha=0.5, out=a), 10)
    rate = 3 * 4 * TRIAD_FLOATS / (t * 1e-3)
    print(f"memory ceiling: 1 GiB float32 triad {t:.3f} ms, {rate / 1e12:.3f} TB/s "
          f"({rate / HBM_BYTES_S:.1%} of 3.35 TB/s; {smi})")
    del a, b, c
    torch.cuda.empty_cache()
    return rate


def roofline_phase(yk, ys, plan, pts, vecs, lam, sfu, smi, dev):
    """K3 against its plain version; K3 and the Yukawa kernel at
    bench_kernels.py's shapes and the main path's two launch shapes, each
    against the SFU bound.  Returns the K3 entry of the kernels line."""
    print(f"roofline: SFU bound {sfu:.4e} pairs/s ({SMS} SMs x {MUFU_PER_CLK} MUFU/clk "
          f"at clocks.max.sm {smi_query('clocks.max.sm')} MHz, {MUFU_PER_PAIR} MUFU a pair)")
    rng = np.random.default_rng(0)
    ys.KERNEL_LAUNCHES = 0
    # the probe against its plain version at the main path's shapes
    rows = np.sort(rng.choice(plan.shell_pos.shape[0],
                              size=min(SAMPLE_ROWS, plan.shell_pos.shape[0]), replace=False))
    errs = []
    for name, q in (("shell sample", plan.shell_pos[torch.as_tensor(rows, device=dev)].contiguous()),
                    ("coarse", plan.coarse_pos)):
        got = ys.skeleton_sum(q, pts, lam)
        ref = ys.skeleton_sum_torch(q, pts, lam)
        torch.cuda.synchronize()
        abs_err = (got - ref).abs().max().item()
        rel = row_rel_err(got, ref)
        errs.append(abs_err)
        print(f"skeleton kernel vs plain  main-path {name} Q={q.shape[0]} S={pts.shape[0]}: "
              f"max abs err {abs_err:.3e}, max err / row sum {rel:.3e} (tol {SKELETON_RTOL:g}; "
              f"{int((ref < ROW_SUM_FLOOR).sum())} rows under the {ROW_SUM_FLOOR:g} floor)")
        check(bool(torch.isfinite(got).all()), f"skeleton {name} finite")
        check(rel <= SKELETON_RTOL, f"skeleton kernel {name} within tolerance")

    rows_out = []
    shapes = [("bench", q_n, s_n) for q_n, s_n in ROOFLINE_SHAPES]
    shapes += [("main-path shell", plan.shell_pos, None), ("main-path coarse", plan.coarse_pos, None)]
    for label, q_spec, s_n in shapes:
        if s_n is None:  # the main path's own launch
            q, p, v, lam_k = q_spec, pts, vecs, lam
        else:
            q = torch.as_tensor(rng.standard_normal((q_spec, 3)), dtype=torch.float32, device=dev)
            p = torch.as_tensor(rng.standard_normal((s_n, 3)) * 0.3, dtype=torch.float32, device=dev)
            v = torch.as_tensor(rng.standard_normal((s_n, 3)), dtype=torch.float32, device=dev)
            lam_k = ROOFLINE_LAM
            got = ys.skeleton_sum(q[:4096], p, lam_k)
            ref = ys.skeleton_sum_torch(q[:4096], p, lam_k)
            check(row_rel_err(got, ref) <= SKELETON_RTOL,
                  f"skeleton kernel at {label} Q={q.shape[0]} S={s_n} within tolerance")
        Q, S = int(q.shape[0]), int(p.shape[0])
        pairs = Q * S
        reps = 3 if pairs > 2e10 else 10
        # turns: K1, K3, K3, K1 (twice) on the same inputs
        t1, t3 = [], []
        for _ in range(2):
            t1.append(time_ms(lambda: yk.yukawa_field_cuda(q, p, v, lam_k), reps))
            t3.append(time_ms(lambda: ys.skeleton_sum_cuda(q, p, lam_k), reps))
            t3.append(time_ms(lambda: ys.skeleton_sum_cuda(q, p, lam_k), reps))
            t1.append(time_ms(lambda: yk.yukawa_field_cuda(q, p, v, lam_k), reps))
        k1_ms, k3_ms = statistics.median(t1), statistics.median(t3)
        noise = max((max(t1) - min(t1)) / k1_ms, (max(t3) - min(t3)) / k3_ms)
        row = dict(shape=label, Q=Q, S=S, pairs=pairs, k1_ms=k1_ms, k3_ms=k3_ms,
                   pct_of_skeleton=100.0 * k3_ms / k1_ms,
                   k1_pairs_s=pairs / (k1_ms * 1e-3), k3_pairs_s=pairs / (k3_ms * 1e-3),
                   k1_pct_sfu=100.0 * pairs / (k1_ms * 1e-3) / sfu,
                   k3_pct_sfu=100.0 * pairs / (k3_ms * 1e-3) / sfu, noise=noise,
                   within_noise=abs(k1_ms - k3_ms) / k1_ms <= noise,
                   k1_chunks=chunks(yk, q, p))
        rows_out.append(row)
        print(f"  {label} Q={Q} S={S}: yukawa {k1_ms:.3f} ms ({row['k1_pairs_s']:.3e} pairs/s, "
              f"{row['k1_pct_sfu']:.1f}% of SFU), skeleton {k3_ms:.3f} ms "
              f"({row['k3_pairs_s']:.3e} pairs/s, {row['k3_pct_sfu']:.1f}% of SFU); "
              f"pct_of_skeleton {row['pct_of_skeleton']:.1f} (K3's time over K1's, a "
              f"ratio of two kernels, not a share of a bound); spread of the turns "
              f"{noise:.1%}{' -- the two differ by less than the noise' if row['within_noise'] else ''}")
    print("roofline rows: " + json.dumps(rows_out))
    launches = ys.KERNEL_LAUNCHES

    main = [r for r in rows_out if r["shape"].startswith("main-path")]
    plain_ms = sum(time_ms(lambda: ys.skeleton_sum_torch(qq, pts, lam), 2)
                   for qq in (plan.shell_pos, plan.coarse_pos))
    k3_ms = sum(r["k3_ms"] for r in main)
    print(f"  skeleton kernel at the main path's two shapes {k3_ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms; skeleton launches in this phase {launches} ({smi})")
    check(launches > 0, "the roofline phase launched the skeleton kernel")
    return {
        "name": "yukawa_skeleton",
        "route": "cuda",
        "source": "shm3d_torch/csrc/yukawa_skeleton.cu",
        "replaces": "bench_kernels.py:92",
        "launches": launches,
        "max_abs_err": max(errs),
        "ms": k3_ms,
        "plain_ms": plain_ms,
        "bound_ms": sum(pair_bound_ms(r["pairs"], r["Q"], r["S"], sfu, 1, 3) for r in main),
        "bound_by": "operations",
        "library_ms": None,
    }, rows_out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import shm3d_torch
    from shm3d_torch import SignedHeatOptions, SignedHeatSolver, make_sphere_cloud
    from shm3d_torch import _build
    from shm3d_torch._device import resolve_device
    from shm3d_torch.ops import yukawa as yk
    from shm3d_torch.ops import yukawa_skeleton as ys
    from shm3d_torch.ops.farfield import DeviceShellPlan, _positions_of
    from shm3d_torch.solve import ell, pell

    check(os.path.dirname(os.path.abspath(shm3d_torch.__file__)) ==
          os.path.join(REPO, "shm3d_torch"), "shm3d_torch imported from this checkout")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"gpu: {smi}")
    dev = resolve_device("cuda")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]} device {torch.cuda.get_device_name(0)}")

    # --- build ---------------------------------------------------------
    t0 = time.perf_counter()
    _build.load_library()
    print(f"kernel build: nvcc {_build.BUILD_INFO['seconds']:.2f} s, "
          f"build + load {time.perf_counter() - t0:.2f} s "
          f"({_build.library_path().name})")
    for line in _build.BUILD_INFO["log"].splitlines():
        if "ptxas info" in line and ("Used" in line or "Compiling" in line) or "spill" in line:
            print(f"  {line.strip()}")

    # --- kernel vs plain on synthetic inputs -------------------------------
    kernel_cases(yk, dev)

    # --- main path ---------------------------------------------------------
    geom = make_sphere_cloud(N_POINTS)
    opts = SignedHeatOptions(dtype="float32", h_coef=H_COEF, refine_steps=0,
                             solver_maxiter=2000, step1_method="auto",
                             disk_cache=False)
    solver = SignedHeatSolver("grid", device="cuda")
    yk.KERNEL_LAUNCHES = 0
    t0 = time.perf_counter()
    res = solver.compute_distance(geom, opts)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    cold_stats = dict(solver.last_stats)
    warm = []
    for _ in range(3):
        t0 = time.perf_counter()
        res = solver.compute_distance(geom, opts)
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
    launches = yk.KERNEL_LAUNCHES
    stats = solver.last_stats
    print(f"main path: sphere cloud S={N_POINTS}, grid {res.grid.n}^3, float32, "
          f"refine_steps=0, step1 auto")
    print(f"  cold solve {cold_s:.3f} s, mem_peak_mb {cold_stats['mem_peak_mb']:.1f}, "
          f"phases {json.dumps(cold_stats['phases'])}")
    print(f"  warm solves {[round(w, 4) for w in warm]} s, median "
          f"{statistics.median(warm):.4f} s, phases {json.dumps(stats['phases'])}")
    cached = next(iter(solver._impl._cache.values()))
    m_rows = int(cached["nodes8"].shape[0])
    print(f"  shell nodes {stats['shell_nodes']} + coarse nodes {stats['coarse_nodes']}, "
          f"constraint rows m={m_rows}, tform_eps {stats['tform_eps']}, "
          f"iters {stats['iters']}, rel_res {stats['rel_res']:.3e}, "
          f"mem_peak_mb {stats['mem_peak_mb']:.1f}")
    print(f"  yukawa kernel launches during the 4 grid solves: {launches}")
    check(launches > 0, "the main path launched the Yukawa kernel")
    check(stats["step3_path"] == "projected-mg-pcg", "step 3 path")
    check(stats["tform_eps"] is not None, "full-row whitening tier at m > 8192")
    check(stats["iters"] > 0 and stats["rel_res"] < 1e-4, "MG-PCG converged")

    # --- correctness of phi --------------------------------------------------
    g = res.grid
    phi = res.phi
    check(phi.shape == (g.n ** 3,), "phi shape")
    finite = bool(np.isfinite(phi).all())
    pos = _positions_of(np.arange(g.n ** 3, dtype=np.int64), g).astype(np.float64)
    exact = np.linalg.norm(pos, axis=1) - 1.0
    rel = float(np.linalg.norm(phi - exact) / np.linalg.norm(exact))
    band = abs(rel - JAX_ANALYTIC_REL_L2) / JAX_ANALYTIC_REL_L2
    print(f"  phi finite {finite}; rel-L2 vs |x|-1 {rel:.6e} (JAX package, same "
          f"input: {JAX_ANALYTIC_REL_L2:.6e}; off by {band:.2%}, limit "
          f"{ANALYTIC_BAND:.0%})")
    check(finite, "phi finite")
    check(band <= ANALYTIC_BAND, "analytic rel-L2 within 10% of the JAX package")
    check_no_jax_package()

    # --- the kernel at the main path's shapes --------------------------------
    plan = next(v for v in cached.values() if isinstance(v, DeviceShellPlan))
    pts, vecs = cached["points"], cached["vectors"]
    lam = float(np.sqrt(1.0 / (opts.t_coef * cached["spacing"] ** 2)))
    rows = np.sort(np.random.default_rng(1).choice(
        plan.shell_pos.shape[0], size=min(SAMPLE_ROWS, plan.shell_pos.shape[0]),
        replace=False))
    sample = plan.shell_pos[torch.as_tensor(rows, device=dev)].contiguous()
    err, _ = compare(yk, sample, pts, vecs, lam, True)
    print(f"kernel vs plain  main-path shell sample Q={sample.shape[0]} "
          f"S={pts.shape[0]}: max err {err:.3e} (tol {DIR_TOL:g})")
    check(err <= DIR_TOL, "shell sample within tolerance")
    # the whole coarse launch: its far rows underflow in an unscaled float32
    # sum (12,099 of them in the speed-of-light probe); here every row must
    # be finite and of unit norm
    err_c, got_c = compare(yk, plan.coarse_pos, pts, vecs, lam, True)
    unit_c = (torch.linalg.vector_norm(got_c, dim=1) - 1).abs().max().item()
    print(f"kernel vs plain  main-path coarse launch Q={plan.coarse_pos.shape[0]} "
          f"S={pts.shape[0]}: max err {err_c:.3e} (tol {DIR_TOL:g}), | |Y|-1 | <= "
          f"{unit_c:.1e}; launches split into {chunks(yk, plan.coarse_pos, pts)} "
          f"(coarse) and {chunks(yk, plan.shell_pos, pts)} (shell)")
    check(bool(torch.isfinite(got_c).all()) and unit_c <= 1e-5,
          "every coarse row finite and of unit norm")
    check(err_c <= DIR_TOL, "coarse launch within tolerance")
    err = max(err, err_c)
    times = {}
    for name, fn, reps in (("kernel", yk.yukawa_field_cuda, 5),
                           ("plain", yk.yukawa_field_torch, 2)):
        t_shell = time_ms(lambda: fn(plan.shell_pos, pts, vecs, lam), reps)
        t_coarse = time_ms(lambda: fn(plan.coarse_pos, pts, vecs, lam), reps)
        times[name] = t_shell + t_coarse
        print(f"  {name}: shell Q={plan.shell_pos.shape[0]} {t_shell:.3f} ms, "
              f"coarse Q={plan.coarse_pos.shape[0]} {t_coarse:.3f} ms "
              f"(S={pts.shape[0]}, {smi})")

    # --- the default tier, the roofline, the paged kernel, the tet path -----
    profile_solve("warm fast-tier grid solve", lambda: solver.compute_distance(geom, opts),
                  statistics.median(warm), smi)
    default_tier_phase(solver, geom, opts, phi, yk, smi)
    check_no_jax_package()
    sfu = sfu_pairs_per_s()
    ceiling = hbm_ceiling(dev, smi)
    k3_entry, _ = roofline_phase(yk, ys, plan, pts, vecs, lam, sfu, smi, dev)
    sell_cases(pell, ell, dev)
    tet_k1, k2_entry = tet_phase(smi, dev, ceiling)
    check_no_jax_package()

    # the Yukawa entry covers both paths: launches summed, the larger error,
    # and ms the kernel time of one solve of each (grid: shell + coarse
    # launches; tet: the barycenter launch); per_path keeps them apart.  No
    # single PyTorch call computes it (library_ms null).
    S = int(pts.shape[0])
    grid_bound = sum(pair_bound_ms(int(qq.shape[0]) * S, int(qq.shape[0]), S, sfu)
                     for qq in (plan.shell_pos, plan.coarse_pos))
    tet_bound = pair_bound_ms(tet_k1["pairs"], tet_k1["queries"], tet_k1["sources"], sfu)
    grid_k1 = dict(launches=launches, max_abs_err=err, ms=times["kernel"],
                   plain_ms=times["plain"], bound_ms=grid_bound)
    tet_k1["bound_ms"] = tet_bound
    print(f"yukawa kernel vs its SFU bound: grid {grid_k1['ms']:.3f} ms vs "
          f"{grid_bound:.3f} ms, tet {tet_k1['ms']:.3f} ms vs {tet_bound:.3f} ms ({smi})")
    print(f"card: {smi}")
    print(json.dumps({"kernels": [{
        "name": "yukawa_field",
        "route": "cuda",
        "source": "shm3d_torch/csrc/yukawa.cu",
        "replaces": "shm3d/ops/yukawa.py:129",
        "launches": launches + tet_k1["launches"],
        "max_abs_err": max(err, tet_k1["max_abs_err"]),
        "ms": grid_k1["ms"] + tet_k1["ms"],
        "plain_ms": grid_k1["plain_ms"] + tet_k1["plain_ms"],
        "bound_ms": grid_bound + tet_bound,
        "bound_by": "operations",
        "library_ms": None,
        "per_path": {"grid": grid_k1, "tet": tet_k1},
    }, k2_entry, k3_entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
