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
   counting the kernel launches it makes (K1's and the Krylov stop
   kernel's) and the warm solves' host reads of the stop state;
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
   plain version (the main path's shapes, a ragged case, a case that spans
   several source chunks, two launches bit for bit), then K3 and the Yukawa
   kernel at bench_kernels.py's three shapes and at the main path's two
   launch shapes, each against the SFU bound (two MUFU operations a pair at
   the card's SM clock), and a 1 GiB float32 triad as the measured memory
   ceiling.  K3's time over K1's (``pct_of_skeleton``) is a ratio of two
   kernels, not a share of a bound;
10. the tet vertex (dual-Laplacian) path through the public API: knot_dec
    with ``use_crouzeix_raviart=False`` (float32, ZERO_SET, refine_steps=1)
    -- one cold and three warm solves that must give one phi bit for bit
    with the sources exactly 0 -- against the JAX package's numbers on the
    same input, with both kernels' launch counts, the divergence twice bit
    for bit, one H matvec through the plain gathers of the host form
    against the sliced-ELL kernel, and warm solves with H on either route;
11. knot_dec's vertices with area-weighted normals as an oriented point
    cloud, LevelSetConstraint.NONE (the ``vnull`` deflation): one cold and
    one warm solve, with the Yukawa kernel held against its plain version at
    that launch's shape and the sliced-ELL kernel on that solve's own
    operator (its normals' checksum is held to the reference script's);
12. greedy integration and the artifact's mode upgrade on bunny_dec with a
    temporary disk cache: ``fast_integration=True`` first, then a default
    (Crouzeix-Raviart) solve on the same solver, which must take the "mode
    upgrade" phase and give the phi of a fresh solve bit for bit, with the
    Yukawa kernel held against its plain version at bunny_dec's barycenters;
13. the main path at 256^3 (h_coef=4): the subsampled-pin fast tier (one
    cold and three warm solves, its row and pin counts held to the port's
    host code), the default tier (one cold and one warm, the correction
    projecting with all rows through the host loop) and a reference
    refined to 1e-11, each tier's solves one phi, the default tier within
    1e-5 of the reference and closer to |x| - 1 than at 128^3 by the
    method's O(h); the Yukawa kernel against its plain version on a sample
    of the 256^3 shell launch and the whole coarse launch, timed against its
    SFU bound;
14. the host-projected tier at 128^3 (max_device_pins=None): one cold and
    two warm solves, each Gram solve on the host between the loop's three
    graphs an iteration, within 1e-5 of the 128^3 reference;
15. fast integration at 128^3: the device wavefront, one graph a chunk of
    16 sweeps (every node visited, two solves one phi) and a constant field
    integrated to its exact linear phi;
16. the CLI on the card: ``python -m shm3d_torch.cli`` on bunny_dec at
    --h 2 writes phi;
17. the grid domain on a device mesh of four shards of the one card
    (``device_mesh(devices=[cuda:0] * 4)``, 1-D and 2 x 2): the slab
    Laplacian and the pin-aware slab V-cycle bitwise equal to the
    single-device ones at 128^3; the dense ring (2,097,152 queries x 52,290
    sources, K1's partial kernel on every hop, its merge kernel at the end)
    against K1 on one device, 1-D and 2-D bitwise equal; the main path on
    both meshes (1 cold + 3 warm each, shell Step 1 split by rows, Step 3
    on z-slabs), held to the single-device iterations, phi and the 128^3
    reference, 2 x 2 bitwise equal to 1 x 4; a dense-Step-1 solve through
    the ring; the default tier on 4 shards against the reference; and 3
    shards, which do not split 128, taking the single-device path.  Every
    mesh solve runs with K1's plain versions replaced by a failing stub, so
    none can reach them;
18. the tet domain on a device mesh of four shards of the one card (1 x 4
    and 2 x 2) on knot_dec: one device builds the host artifact once in a
    temporary disk cache (the CR family, then the vertex family by the mode
    upgrade) and the mesh solvers read it; 1 cold + 2 warm CR solves on
    1 x 4 and one on 2 x 2 (one phi, 2 x 2 = 1 x 4 bit for bit, within the
    JAX package's bands and the residual limits), one vertex-path solve on
    1 x 4 (sources exactly 0, within the vertex bands), every mesh solve
    with K1's and K2's plain versions replaced by failing stubs; Step 3 on
    the CR and the vertex path given the single device's Y, bitwise equal to
    the single device's; K2 on the row blocks of the face operator and of
    S H S, bitwise equal to one launch, timed against it; K1's ring at the
    barycenters, 1 x 4 = 2 x 2 bit for bit and within 1e-4 of one launch;
    the launches of one profiled warm mesh solve (one device's eager solve
    is profiled in phase 22);
19. the grid's MINRES-on-KKT Step 3 (``solver_method="minres_kkt"``), every
    solve with K1's plain versions stubbed to fail: 20 iterations at 128^3
    timed first; the icosphere at 16^3 with Step 3 in float64 on the card
    (given K1's Y) within 1e-7 of projected CG; one solve of the main
    path's input at the default solver_maxiter (iterations, phibar, time,
    K1 twice, phi against the fast tier and |x| - 1); a profiled solve of
    20 iterations; at 200 iterations two solves one phi and four shards of
    the card within 10x the change a rounding-size perturbation of Y makes;
    the default tier after MINRES against phase 8's reference; K1 against
    its plain version at the path's launch shapes;
20. float64 on the card (``dtype="float64"``), every solve on the card with
    K1's and K2's plain versions stubbed to fail and counted by K1's
    float64 launch counts: (a) K1's float64 instantiation against its
    float64 plain version (ragged, coincident, far, padded; fused and
    split), its -Xptxas -v lines and FP64 instructions a pair read from the
    SASS; (b) sphere52k-128 in float64, 1 cold + 2 warm (the
    host-projected tier, residual <= 1e-10, one phi, 2 float64 K1 launches
    and no K2 a solve, against |x| - 1 and phase 8's reference), then the
    float64 kernel at its two launches against its plain version and timed
    against the float32 kernel in turns, with its FP64 bound; (c) the 16^3
    icosphere at solver_tol=1e-12 against the host oracle; (d) bunny_dec
    CR and vertex against the same solves on this machine's CPU, knot_dec
    CR (cold) against the JAX package's float32 numbers; (e) the grid and
    bunny_dec CR on 1 x 4 and 2 x 2 meshes of the card; (f) the CLI with
    ``--dtype float64``;
21. the Krylov stop kernel (``shm3d_torch/csrc/krylov_stop.cu``) against
    its plain version bit for bit on the inputs its host test reads in the
    first Krylov solve of eager solves, recorded: CG's r.z in float32 on
    the main path and knot_dec CR and in float64 on the 16^3 icosphere,
    MINRES's (phibar, beta) at 200 iterations in float32; the whole stop
    state and the predicate after every call, the stop where the solve
    stopped; the chunk graphs' start kernel against its plain version (a
    WHILE and an IF node run their body as its condition says); each
    instantiation's launch timed against the plain version;
22. the device programs against the eager loops
    (``shm3d_torch/solve/graphs.py``): the Krylov solves as a setup graph
    and chunk graphs whose WHILE node runs to the device stop test (MINRES's
    iteration 0 under an IF node), the grid's
    Steps 1-2, divergence and mean shift as stage graphs, on the main path
    at 128^3 (fast and default tier), the 256^3 fast tier, knot_dec CR,
    knot_dec vertex, the point cloud's NONE mode and MINRES at 200
    iterations; the host-projected loop on sphere52k-128 (phase 14),
    sphere52k-128-f64 (phase 20) and the 256^3 default tier's corrections;
    the wavefront at 128^3.  Warm solves on the eager loops and stages and
    on the graphs in turns (eager, graph, graph; the 256^3 default tier,
    7-9 s a solve, one eager and one graphed turn) on the same
    solver, held bit for bit equal (phi, iterations, residuals, Gram-solve
    counts, sweeps) with equal K1 and K2 launches; the graphed solves'
    graph launches (counted by the port) and host reads of the stop state
    as their stats predict (one a stage, a setup, a chunk graph and one
    read a Krylov solve, MINRES one chunk graph more, three a
    host-projected iteration, one a chunk of sweeps), one conditional node
    in every chunk graph; one profiled eager solve (the
    256^3 default tier: none) and a profiled graphed solve on the main path
    and the paths without a chunk graph (the profiler traces the kernels
    inside conditional bodies only in part, and one run ended in an illegal
    memory access under it): the host's kernel launch calls and graph
    launches, the device's kernel events, mem_peak_mb, fewer than 100
    kernel launch calls in a warm main-path solve; the graphed solves' busy
    share estimated from the eager solve's kernel time; the graphs' pool MB;
23. the full-row projector's packed-triangle kernel
    (``shm3d_torch/csrc/tri_gemv.cu``), run right after phase 8 on the main
    path's own factor (m = 15,706): T x and T^T x, kernel and plain
    version, against the float64 product within the float32 rounding
    bound, two calls bit for bit; a warm fast-tier and a warm default-tier
    solve launch it once for each product with T
    (``projection.TMAT_PRODUCTS``); a product timed against its bytes bound,
    the plain version and torch.mv over the dense square (a yardstick).
24. the V-cycle's fused stencil kernels (``shm3d_torch/csrc/mg_stencil.cu``),
    run after phase 23 on the main path's own pin masks: the Jacobi sweep
    (from u and from zero), the residual and the Laplacian at 128^3 and the
    coarsest level's 40 sweeps in one launch at 8^3, each bit for bit its
    plain op chain, each timed in a CUDA graph against its bytes bound and
    against the plain chain (a yardstick), the 128^3 ops on eight input sets
    in turn, so that a launch reads device memory and not L2; one pinned
    V-cycle at 128^3, plain against fused, each replayed in a graph, bit
    for bit; the same ops, the 8^3 sweeps and pinned and unpinned V-cycles
    in float64 on pins built in float64, and an unpinned float32 V-cycle,
    bit for bit; a warm fast-tier and a warm default-tier solve:
    ``STENCIL_LAUNCHES`` against the count their iterations give
    (``stencil_path``), the main path's 16 iterations and the default
    tier's 38.  The wavefront, host-projected, MINRES and float64 grid
    phases check their warm solves' launches the same way (the wavefront's
    none); the tet phase launches none of them.

Every one-device solve on the card replays its device programs as CUDA
graphs: the eager loops (``krylov.cg``, ``krylov.minres``,
``solvers.grid.hostproj_iteration``, ``ops.wavefront.sweep_loop``) are
replaced by guards that fail the run on one device's CUDA vectors, except in
phase 22's eager turns, phase 21's recording solves and the tet domain's
row-split mesh solves, which stay eager by design (z-slab solves pass).  The earlier phases' readings repeat those
taken on the eager loops before the graphs: checked where PERF.md records
them (the main path's iterations and rel-L2, the face and vertex
iterations, MINRES's iterations and phibar, the float64 iterations).

Each grid phase prints the projector's tier it took (bmat, full-row,
subsampled or host-projected).  Every kernel's launch count is set to 0 just before the path that runs it
and read just after.  The last two lines of standard output are a JSON
summary of the kernels and the JSON status line; the card's name and power
limit come before them.  Any failed check exits non-zero before them; so
does a machine without CUDA, and a directory without the repository.
"""

import contextlib
import hashlib
import itertools
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

# vertex phase: knot_dec with use_crouzeix_raviart=False, and its vertices as
# a point cloud in NONE mode.  The JAX package on the same inputs
# (scripts/jax_tet_vertex_reference.py: CPU, JAX x64 off, float32 solves with
# f64 defect correction): 674 iterations, f64 residual passes 1.932e-5 ->
# 3.241e-7 -> 1.308e-9 -> 2.611e-7 (its last pass lost ground), phi below
JAX_VERTEX = dict(min=-9.281331062316895, max=144.6066131591797,
                  mean_abs=54.88045830828255)
JAX_VERTEX_RESIDUAL = 2.611042479776801e-07
JAX_CLOUD = dict(min=-10.806187629699707, max=147.87635803222656,
                 mean_abs=59.98338588367128, src_mean_abs=1.5110259604260776)
JAX_CLOUD_VERTICES, JAX_CLOUD_RESIDUAL = 70070, 9.570616500732421e-11
JAX_CLOUD_NORMALS = 2549.3389745351783   # the script's checksum of the cloud's normals
# relative bands: both packages end float32 AMG-CG plus f64 correction at or
# below a 3e-7 residual, in other summation orders, and round phi to float32
# (6e-8); the single interior minimum moves most, as on the CR path
VERTEX_BANDS = dict(min=1e-3, max=1e-4, mean_abs=1e-4, src_mean_abs=1e-4)
VERTEX_RESIDUAL_MAX = 1e-5
BUNNY = os.path.join(REPO, "tests", "data", "bunny_dec.obj")

# default tier on the main path's input.  The JAX package on the same input
# (shm3d.solvers.grid.GridSolver, CPU, JAX x64 off, so float32 solves with
# two-float residuals, as on the TPU): rel-L2 of each tier against the
# solve refined to 1e-11, and the default tier's per-pass f64 residuals
JAX_REL_L2_FAST_TIER = 1.0620449766978294e-06
JAX_REL_L2_DEFAULT_TIER = 3.324839665958726e-10
JAX_DEFAULT_PASS_RELS = [7.832e-05, 6.361e-07, 5.852e-09, 3.409e-11]
FAST_TIER_REL_L2_MAX = 1e-5    # the reference's accuracy bar (BASELINE.md)

# 256^3 (h_coef=4): the stand-in's constraint rows and subsampled pin rows,
# counted with the port's host code (griddom.constraint_rows,
# subsample_pin_rows at max_device_pins=4096)
H_COEF_256 = 4.0
ROWS_256, PINS_256 = 45532, 2849
# the subsampled fast tier's distance from its refined reference: shm3d
# measured 9.5e-4 with 4,096 pins (shm3d/solvers/grid.py, the comment at its
# full-row tier); the limit only catches a tier that does not pin at all
SUBSAMPLED_REL_L2_MAX = 1e-2
# the method is O(h): halving h about halves phi's distance from |x| - 1
ANALYTIC_RATIO_256 = (0.4, 0.6)
GRID_KERNELS = ("yukawa_partial", "yukawa_merge")
# the packed-triangle kernel (csrc/tri_gemv.cu) and its plain version
# against the float64 product with the same float32 factor, row by row:
# |got - exact| / (|T| |x|) of a row stays under the float32 rounding bound
# of a sum in blocks, (tile + tile rows) x 2^-24 (a thread sums 4-term dots
# over at most nb tiles, then 16 or 32 partials in a tree)
TRI_TILE_ROWS_EPS = 2.0 ** -24

# phase 19, MINRES on the KKT system at 128^3 in float32.  Limits from
# scripts/minres_kkt_cpu.py (both packages on the CPU, the main path's input
# at 32^3 and 64^3): phi's rel-L2 against the projected-CG fast tier reached
# 5.97e-4 (the JAX package at 32^3, where it ran to solver_maxiter), and its
# rel-L2 against |x| - 1 stayed within 0.26% of the fast tier's; the JAX
# package's default tier after MINRES came within 8.9e-10 of the refined
# reference at 64^3, so the port's is held to the 1e-5 bar
MINRES_REL_L2_FAST_MAX = 1e-3
MINRES_ANALYTIC_BAND = 0.01
MINRES_DEFAULT_REL_L2_MAX = 1e-5
# MINRES amplifies a rounding difference for hundreds of iterations before
# the iterates re-converge, so at 200 iterations the mesh's shard-ordered
# dots move u as far as a rounding-size change of Y does (0.3-1.3x in
# tests/test_torch_minres.py's CPU mesh case); the mesh is held to this
# many times the larger of two such perturbations, as that test holds it
MINRES_MESH_SENSITIVITY = 10.0

# phase 20, float64 on the card.  K1's float64 instantiation against its
# float64 plain version: max |diff| / max |ref| per row (the same formula
# in one precision, summed in another order: ~1e-15, ~1e-14 far from every
# source, where the exponents reach ~2e3); the 128^3 solve to the float64
# solver tolerance; the 16^3 icosphere at solver_tol=1e-12 within the
# bound tests/test_torch_grid_tiers.py holds the CPU to against the host
# oracle; the card against the CPU, and a mesh against one device, within
# the bound the CPU tests hold the same float64 solves to against shm3d
# (the same AMG or MG-CG to 1e-10 in another summation order: a rounding
# change of Y moves where bunny_dec's CR solve stops, 647 iterations on
# the card, 754 on the CPU, 667 on the ring's Y); the grid's mesh, whose
# Y is one device's bit for bit, within 1e-9.  knot_dec's float64 CR: the
# AMG-CG plateaus near 6e-6 for longer than both packages' float64 stall
# window (1,000 iterations, shm3d/tet/solver.py:_stall_window), which ends
# it there (scripts/knot_f64_stall.py runs it past the window), so its
# residual is held below the float32 path's (the JAX package's 2.2e-4),
# and its phi to the JAX package's float32 numbers: 1e-2 on the single
# interior minimum, 1e-3 on the other three
F64_ROW_RTOL = 1e-12
F64_RESIDUAL_MAX = 1e-10
F64_ORACLE_REL_L2_MAX = 1e-6
F64_CPU_REL_L2_MAX = 1e-8
F64_MESH_REL_L2_MAX = 1e-9
F64_TET_MESH_REL_L2_MAX = 1e-8
F64_KNOT_RESIDUAL_MAX = 1e-4
F64_PHI_BANDS = dict(min=1e-2, max=1e-3, mean_abs=1e-3, src_mean_abs=1e-3)

# the earlier phases' readings on the eager loops (chip runs on an NVIDIA
# H100 80GB HBM3, 700 W, before the graphs; PERF.md), which the iteration
# graphs repeat bit for bit: the main path's iterations and rel-L2 against |x| - 1, the
# knot_dec face and vertex iterations, MINRES at 128^3, and in float64
# sphere52k-128 (iterations, residual), bunny_dec CR and knot_dec CR.  The
# main path's reading is the packed-triangle kernel's (its sums run in
# another order than cuBLAS's over the square, which read 8.774781e-03);
# the float64 residual is that of the host Gram factor in SuperLU's
# symmetric mode (the default column ordering read 8.6153e-11)
EAGER_MAIN = (16, "8.774778e-03")
# the default tier's Krylov iterations on the main path's input: the
# primary solve's and its three correction solves', 16 + 6 + 8 + 8 (PERF.md)
DEFAULT_KRYLOV_ITERS = 38
EAGER_FACE_ITERS, EAGER_VERTEX_ITERS = 341, 362
EAGER_MINRES = (3973, "1.3055e-02")
EAGER_F64_GRID = (76, "8.6288e-11")
EAGER_F64_BUNNY_CR_ITERS, EAGER_F64_KNOT_ITERS = 647, 3245
# phase 22: a warm graphed main-path solve makes fewer kernel launch calls
# than this (Steps 1-2, the divergence, the Krylov setup and the mean shift
# are graphs; what stays eager is a handful of ops around them)
MAIN_LAUNCH_CALLS_MAX = 100
# phase 22's paths whose eager solve runs under the profiler: those with a
# Krylov chunk graph, whose graphed solve's busy share is estimated from it
# (not the 256^3 default tier, 7-9 s a solve)
EAGER_PROFILED = ("sphere52k-128 fast tier", "sphere52k-128 default tier",
                  "sphere52k-256 fast tier", "sphere52k-128 MINRES, 200 iterations",
                  "knot_dec CR", "knot_dec vertex", "knot_dec point cloud NONE")
# phase 22's paths whose graphed solve runs under the profiler: the main path
# (its launch-call check) and the paths without a Krylov chunk graph
GRAPH_PROFILED = ("sphere52k-128 fast tier", "sphere52k-128 host-projected",
                  "sphere52k-128-f64 host-projected", "sphere52k-128 wavefront")
# phase 22: the stats a graphed solve repeats bit for bit
GRAPH_STAT_KEYS = ("iters", "rel_res", "residual", "refine_pass_rels", "refine_rel_res",
                   "correction_iters", "proj_iters", "proj_residual", "proj_refine_pass_rels",
                   "wavefront_sweeps", "wavefront_visited")
FP64_LANES = 64                # H100 SXM: FP64 results a clock an SM
STENCIL_SETS = 8               # phase 24: 8 x 3 x 8.4 MB of inputs, four times the L2
FP64_FLOOR_PER_PAIR = 12       # 3 sub, 3 for r^2, r, the exponent, the weight, 3 sums

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


# Every one-device solve on the card replays its Krylov iterations, its
# host-projected loop and its wavefront sweeps as CUDA graphs.  The eager
# loops run there only where a phase asks for them: phase 22's comparison
# and the tet domain's row-split mesh solves, which stay eager by design.
EAGER_LOOPS = {"allowed": False}
# phase 22's paths, registered by the phases that drive them first:
# name -> (solver, geometry, options, turns); turns: the eager and graphed
# warm solves in their order (a profiled solve of each mode in them follows)
GRAPH_PATHS = {}
TURNS = ("eager", "graph", "graph")
# phase 21's paths, whose eager solve's stop-test inputs the stop kernel is
# held to: name -> (solver, geometry, options)
STOP_PATHS = {}
# the fused stencil kernels' launches in the warm one-device grid solves of
# phase 24 and the phases after it, each path's against the count its
# iterations give (``stencil_path``): name -> launches, expected, per solve
STENCIL_PATHS = {}
STENCIL_COUNTER = "shm3d_torch.solve.multigrid.STENCIL_LAUNCHES"
CAPTURES_COUNTER = "shm3d_torch.solve.graphs.CAPTURES"


def refuse_eager_loops(graphs):
    """The eager loops replaced by guards that fail the run when they get
    one CUDA device's vectors outside ``eager_allowed`` (such a solve must
    replay its graphs): ``krylov.cg`` and ``krylov.minres``, the grid's
    host-projected iteration (``solvers.grid.hostproj_iteration``) and the
    wavefront's sweep loop (``ops.wavefront.sweep_loop``); z-slabs pass."""
    from shm3d_torch.ops import wavefront
    from shm3d_torch.solve import krylov
    from shm3d_torch.solvers import grid

    def guard(mod, name, vector):
        loop = getattr(mod, name)

        def run(*args, **kwargs):
            if graphs.one_cuda_vector(vector(*args, **kwargs)) and not EAGER_LOOPS["allowed"]:
                check(False, f"a solve on the card ran the eager loop {mod.__name__}.{name}")
            return loop(*args, **kwargs)

        setattr(mod, name, run)

    guard(krylov, "cg", lambda matvec, b, *args, **kwargs: b)
    guard(krylov, "minres", lambda matvec, b, *args, **kwargs: b)
    guard(grid, "hostproj_iteration", lambda s, *args: s["u"])
    guard(wavefront, "sweep_loop", lambda phi, *args: phi)


@contextlib.contextmanager
def eager_allowed():
    prev, EAGER_LOOPS["allowed"] = EAGER_LOOPS["allowed"], True
    try:
        yield
    finally:
        EAGER_LOOPS["allowed"] = prev


@contextlib.contextmanager
def eager_loops():
    """One-device solves on the eager loops and stages (``graphs.runner``,
    ``stage_runner``, ``hostproj_runner`` and ``wavefront_runner`` give no
    graph), for phases 21 and 22."""
    from shm3d_torch.solve import graphs

    names = ("runner", "stage_runner", "hostproj_runner", "wavefront_runner")
    saved = [getattr(graphs, n) for n in names]
    for n in names:
        setattr(graphs, n, lambda *args, **kw: None)
    try:
        with eager_allowed():
            yield
    finally:
        for n, f in zip(names, saved):
            setattr(graphs, n, f)


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


def host_us(fn, reps: int) -> float:
    """Mean host time of one fn() call in microseconds: the time to enqueue
    its work, the device not waited for (a launch-bound solve pays it)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / reps * 1e6


def chunks(yk, q, p) -> str:
    """The source split of the Yukawa kernel's launch on these shapes."""
    Q, S = int(q.shape[0]), int(p.shape[0])
    n = yk.yukawa_chunk_len(Q, S, q.device)
    return f"{-(-S // n)} chunks of {n} sources x {-(-Q // 1024)} query blocks"


def profile_solve(label, fn, warm_s, smi, names=("sell_kernel", "yukawa_partial", "yukawa_merge"),
                  rounds=1, eager=False):
    """One solve under torch.profiler (``rounds=2``: after one profiled
    warm-up, the profiler's own start-up, which the first profile of the
    process needs): the device time of its kernels (kernel events
    only: an operator's row repeats its kernels' time), its wall time, the
    kernels that took most device time, and the device time of the kernels
    whose names contain ``names``.  ``warm_s``: the unprofiled warm solve's
    wall time, which the kernels' time is also held against.  ``eager``: the
    solve on the eager loops and stages, for a path whose Krylov solves are
    chunk graphs (the profiler traces the kernels inside their conditional
    bodies only in part, and one run ended in an illegal memory access
    under it)."""
    from torch.profiler import ProfilerActivity, profile

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        # device activity only: the numbers below read kernel events, and the
        # host ops' events cost the script tens of seconds a solve to collect
        with profile(activities=[ProfilerActivity.CUDA]) as prof, \
                eager_loops() if eager else contextlib.nullcontext():
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
    launches = sum(e.count for e in kernels)
    label += " (on the eager loops: the same kernels)" if eager else ""
    print(f"  profiled {label}: {total_ms:.1f} ms of kernel time in "
          f"{launches} launches, {wall_ms:.1f} ms of wall time "
          f"under the profiler (busy {total_ms / wall_ms:.1%}; {total_ms / 1e3 / warm_s:.1%} "
          f"of the unprofiled warm median {warm_s:.4f} s); {ours}; top: {top} ({smi})")
    return dict(kernel_ms=total_ms, launches=launches)


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


def sell_csr(pell, S):
    """The nonzeros of a device SellMat as a torch CSR tensor (int32
    indices), for the library's product of the same operator."""
    widths = (S.slice_ptr[1:] - S.slice_ptr[:-1]) // pell.SELL_C
    first = torch.arange(S.n_slices, device=S.vals.device) * pell.SELL_C
    lane = torch.arange(S.n_slots, device=S.vals.device) & (pell.SELL_C - 1)
    rows = torch.repeat_interleave(first, widths * pell.SELL_C) + lane
    keep = S.vals != 0
    A = torch.sparse_coo_tensor(torch.stack([rows[keep], S.cols[keep].to(torch.int64)]),
                                S.vals[keep], size=(S.n_rows, S.n_cols)
                                ).coalesce().to_sparse_csr()
    return torch.sparse_csr_tensor(A.crow_indices().to(torch.int32),
                                   A.col_indices().to(torch.int32), A.values(),
                                   size=(S.n_rows, S.n_cols))


def k2_at(pell, S, seed, smi, what):
    """The sliced-ELL kernel against its plain version on a path's own
    device operator; returns its numbers for the kernels line: the error,
    the kernel's, the plain version's and cuSPARSE's time of one product,
    and the time its useful bytes take at the published memory rate."""
    x = torch.as_tensor(np.random.default_rng(seed).standard_normal(S.n_cols),
                        dtype=torch.float32, device=S.vals.device)
    err, rel = sell_compare(pell, S, x)
    check(rel <= PELL_RTOL, f"sliced-ELL kernel on the {what} within tolerance")
    A = sell_csr(pell, S)
    y_ref = pell.sell_matvec_torch(S, x)
    lib_rel = ((A @ x - y_ref).abs().max() / y_ref.abs().max()).item()
    check(lib_rel <= PELL_RTOL, f"cuSPARSE product of the {what} agrees with the plain version")
    t_k, t_l = [], []
    for _ in range(2):  # turns: kernel, library, library, kernel
        t_k.append(time_ms(lambda: pell.sell_matvec_cuda(S, x), 50))
        t_l.append(time_ms(lambda: A @ x, 50))
        t_l.append(time_ms(lambda: A @ x, 50))
        t_k.append(time_ms(lambda: pell.sell_matvec_cuda(S, x), 50))
    t_plain = time_ms(lambda: pell.sell_matvec_torch(S, x), 5)
    nonzeros = int((S.vals != 0).sum())
    bound_ms = (8 * nonzeros + 4 * (S.n_cols + S.n_rows)) / HBM_BYTES_S * 1e3
    print(f"sliced-ELL kernel vs plain  {what} ({S.n_rows} rows, {nonzeros} nonzeros in "
          f"{S.n_slots} slots): max err {err:.3e}, relative {rel:.3e} (tol {PELL_RTOL:g}); "
          f"kernel {statistics.median(t_k):.4f} ms (turns {[round(t, 4) for t in t_k]}), "
          f"plain {t_plain:.3f} ms, cuSPARSE CSR {statistics.median(t_l):.4f} ms (turns "
          f"{[round(t, 4) for t in t_l]}), useful bytes at 3.35 TB/s {bound_ms:.4f} ms ({smi})")
    return dict(max_abs_err=err, ms=statistics.median(t_k), plain_ms=t_plain,
                bound_ms=bound_ms, library_ms=statistics.median(t_l))


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
    """The tet path on knot_dec; returns (the Yukawa kernel's, the
    sliced-ELL kernel's numbers on this path).  ``ceiling`` is
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
              f"face iters {st['iters']} (solves {device_solves(st)}), f64 residual "
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
    check(all(r["stats"]["iters"] == EAGER_FACE_ITERS for r in runs),
          f"the face solves repeat the eager loops' {EAGER_FACE_ITERS} iterations")
    GRAPH_PATHS["knot_dec CR"] = (solver, geom, opts, TURNS)
    STOP_PATHS["knot_dec CR, CG float32"] = (solver, geom, opts)

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
    k1 = dict(launches=k1_launches, max_abs_err=k1_err, ms=k1_ms, plain_ms=k1_plain_ms,
              pairs=int(q.shape[0]) * int(pts.shape[0]), queries=int(q.shape[0]),
              sources=int(pts.shape[0]))
    one = dict(warm_median_s=statistics.median(warm), iters=stats["iters"],
               k2_ms=t_kernel, k1_ms=k1_ms, k2_per_solve=runs[-1]["k2"],
               mem_peak_mb=stats["mem_peak_mb"])
    return k1, dict(launches=k2_launches, max_abs_err=err, ms=t_kernel, plain_ms=t_plain,
                    bound_ms=bound_ms, library_ms=t_lib), one


def timed_solves(solver, geom, opts, n, yk, pell):
    """n solves of one input: per solve the wall time, both kernels' launches,
    the stats and a hash of phi; and the last result."""
    runs = []
    for _ in range(n):
        k1, k2 = yk.KERNEL_LAUNCHES, pell.KERNEL_LAUNCHES
        t0 = time.perf_counter()
        res = solver.compute_distance(geom, opts)
        torch.cuda.synchronize()
        runs.append(dict(s=time.perf_counter() - t0, k1=yk.KERNEL_LAUNCHES - k1,
                         k2=pell.KERNEL_LAUNCHES - k2, stats=dict(solver.last_stats),
                         phi=hashlib.sha1(res.phi.tobytes()).hexdigest()))
    return runs, res


def device_solves(st) -> list:
    """Each Krylov solve of a solve, from its spans: iterations and seconds."""
    return [{"iters": dict(a)["iters"], "s": round((t1 - t0) / 1e9, 3)}
            for name, _, _, t0, t1, a in st.get("spans", ())
            if name.endswith("solve") and "iters" in dict(a)]


def span_s(st, name: str, under: str = None) -> tuple:
    """(occurrences, seconds) of the spans called ``name`` in a solve (a
    tally's count and total); with ``under``, only those inside the first
    span of that name."""
    spans = st.get("spans", ())
    top = next((i for i, x in enumerate(spans) if x[0] == under), None)
    n, ns = 0, 0
    for sname, parent, _, t0, t1, a in spans:
        if under is not None:
            while parent > top:
                parent = spans[parent][1]
            if parent != top:
                continue
        if sname == name:
            a = dict(a)
            n += a.get("count", 1)
            ns += a.get("total_ns", t1 - t0)
    return n, ns / 1e9


def print_solves(runs):
    for k, r in enumerate(runs):
        st = r["stats"]
        print(f"  solve {k} ({'cold' if k == 0 else 'warm'}): {r['s']:.3f} s, yukawa launches "
              f"{r['k1']}, sliced-ELL launches {r['k2']}, iters {st['iters']} (solves "
              f"{device_solves(st)}), f64 residual passes {st['refine_pass_rels']}, "
              f"mem_peak_mb {st['mem_peak_mb']:.1f}, phases {json.dumps(st['phases'])}")


def check_bands(res, ref, bands, what):
    """phi statistics within ``bands`` of the JAX package's."""
    phi = res.phi
    got = dict(min=float(phi.min()), max=float(phi.max()),
               mean_abs=float(np.abs(phi).mean()),
               src_mean_abs=float(np.abs(res.phi_at_sources()).mean()))
    for name, want in ref.items():
        off, limit = abs(got[name] - want) / abs(want), bands[name]
        print(f"  phi {name} {got[name]:.6f} (JAX package {want:.6f}): off by "
              f"{off:.3e} (limit {limit:g})")
        check(off <= limit, f"{what}: phi {name} within {limit:g} of the JAX package")


def check_phi_bands(res, ref, what):
    """phi statistics within VERTEX_BANDS of the JAX package's."""
    check_bands(res, ref, VERTEX_BANDS, what)


def k1_at(yk, cached, opts, smi, what):
    """The Yukawa kernel against its plain version at a tet path's own
    launch shape; returns its numbers for the kernels line."""
    q, pts, vecs = cached["barys"], cached["points"], cached["vectors"]
    lam = float(np.sqrt(1.0 / (opts.t_coef * cached["spacing"] ** 2)))
    err, _ = compare(yk, q, pts, vecs, lam, True)
    print(f"kernel vs plain  {what} Q={q.shape[0]} S={pts.shape[0]}: "
          f"max err {err:.3e} (tol {DIR_TOL:g}; {chunks(yk, q, pts)})")
    check(err <= DIR_TOL, f"Yukawa kernel at the {what} within tolerance")
    ms = time_ms(lambda: yk.yukawa_field_cuda(q, pts, vecs, lam), 20)
    plain_ms = time_ms(lambda: yk.yukawa_field_torch(q, pts, vecs, lam), 3)
    print(f"  yukawa kernel {ms:.3f} ms, plain {plain_ms:.3f} ms at the {what} "
          f"(1 launch per solve; {smi})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                pairs=int(q.shape[0]) * int(pts.shape[0]), queries=int(q.shape[0]),
                sources=int(pts.shape[0]))


def vertex_phase(smi, dev):
    """The tet vertex (dual-Laplacian) path on knot_dec; returns (Yukawa
    launches of its four solves, the sliced-ELL kernel's numbers on this
    path's operator with the four solves' launches)."""
    from shm3d_torch import SignedHeatOptions, SignedHeatSolver
    from shm3d_torch.io.mesh_io import read_geometry
    from shm3d_torch.ops import yukawa as yk
    from shm3d_torch.solve import ell, pell
    from shm3d_torch.tet.solver import SignedHeatTetSolver, _divergence

    geom = read_geometry(KNOT)
    opts = SignedHeatOptions(use_crouzeix_raviart=False, disk_cache=False)
    solver = SignedHeatSolver("tet", device=dev)
    yk.KERNEL_LAUNCHES = 0
    pell.KERNEL_LAUNCHES = 0
    runs, res = timed_solves(solver, geom, opts, 4, yk, pell)
    k1_launches, k2_launches = yk.KERNEL_LAUNCHES, pell.KERNEL_LAUNCHES
    cached = next(iter(solver._impl._cache.values()))
    H = cached["H_ell"]
    stats = runs[-1]["stats"]
    warm = [r["s"] for r in runs[1:]]
    print(f"vertex path: knot_dec.obj, use_crouzeix_raviart=False (ZERO_SET, "
          f"float32, refine_steps=1), disk_cache=False")
    print(f"  mesh: {res.mesh.n_vertices} vertices, {res.mesh.n_tets} tets, "
          f"{res.mesh.n_src} source vertices; S H S: {type(H).__name__} on the card, "
          f"{H.nnz} entries in {H.n_slices} slices, {H.n_slots} slots "
          f"({H.nnz / H.n_slots:.1%} filled); amg sizes {stats['amg_sizes']}; level "
          f"operators {[type(l.A).__name__ for l in cached['amg'][opts.level_set_constraint].levels]}")
    print_solves(runs)
    print(f"  warm solves {[round(w, 4) for w in warm]} s, median "
          f"{statistics.median(warm):.4f} s, {statistics.median(warm) / stats['iters'] * 1e3:.2f} "
          f"ms an iteration; sliced-ELL launches an iteration "
          f"{runs[-1]['k2'] / max(stats['iters'], 1):.2f} ({smi})")
    print(f"  kernel launches in the 4 solves: yukawa {k1_launches}, sliced ELL "
          f"{k2_launches}; distinct phi {len({r['phi'] for r in runs})}; max |phi| at "
          f"the sources {np.abs(res.phi_at_sources()).max()}; final f64 residual "
          f"{stats['residual']:.3e} (limit {VERTEX_RESIDUAL_MAX:g}; JAX package "
          f"{JAX_VERTEX_RESIDUAL:.3e})")
    check(all(r["stats"]["step3_path"] == "vertex" for r in runs), "step 3 took the vertex path")
    check(res.phi.shape == (KNOT_VERTICES,) and bool(np.isfinite(res.phi).all()),
          "vertex-path phi finite, one value a tet vertex")
    check(len({r["phi"] for r in runs}) == 1, "the four vertex-path solves give one phi")
    check(float(np.abs(res.phi_at_sources()).max()) == 0.0, "ZERO_SET sources exactly 0")
    check(all(r["k1"] == 1 and r["k2"] > 0 for r in runs),
          "every vertex-path solve launched both kernels")
    check(isinstance(H, pell.SellMat), "the float32 vertex operator is sliced ELL on the card")
    check(all(r["stats"]["residual"] <= VERTEX_RESIDUAL_MAX for r in runs), "vertex residual")
    check(all(r["stats"]["iters"] == EAGER_VERTEX_ITERS for r in runs),
          f"the vertex solves repeat the eager loops' {EAGER_VERTEX_ITERS} iterations")
    GRAPH_PATHS["knot_dec vertex"] = (solver, geom, opts, TURNS)
    check_phi_bands(res, JAX_VERTEX, "vertex path")

    # the divergence twice on the solve's own field
    lam = float(np.sqrt(1.0 / (opts.t_coef * cached["spacing"] ** 2)))
    Y = yk.yukawa_field(cached["barys"], cached["points"], cached["vectors"], lam)
    div = [_divergence(Y, cached["div_rows"], cached["div_tets"], cached["div_gvec"],
                       res.mesh.n_vertices) for _ in range(2)]
    check(torch.equal(*div), "two divergence calls agree bit for bit")
    print(f"  divergence: {cached['div_rows'].shape[0]} entries, two calls bitwise equal")

    # one H matvec: the host form's plain gathers against the sliced-ELL kernel
    _, vdev = SignedHeatTetSolver._build_vertex_ops(res.mesh, np.float32)
    H_plain = ell.device_put_tree(vdev["H_ell"], dev)
    k2 = k2_at(pell, H, 4, smi, "vertex path's S H S")
    k2["launches"] = k2_launches
    x = torch.as_tensor(np.random.default_rng(4).standard_normal(H.n_cols),
                        dtype=torch.float32, device=dev)
    y_plain = pell.apply(H_plain, x)
    rel_routes = ((y_plain - pell.sell_matvec_torch(H, x)).abs().max()
                  / y_plain.abs().max()).item()
    check(rel_routes <= PELL_RTOL, "the two encodings of S H S agree")
    t_k, t_p = [], []
    for _ in range(2):  # turns: kernel, plain, plain, kernel
        t_k.append(time_ms(lambda: pell.sell_matvec_cuda(H, x), 50))
        t_p.append(time_ms(lambda: pell.apply(H_plain, x), 50))
        t_p.append(time_ms(lambda: pell.apply(H_plain, x), 50))
        t_k.append(time_ms(lambda: pell.sell_matvec_cuda(H, x), 50))
    useful = 8 * H.nnz + 4 * (H.n_cols + H.n_rows)
    print(f"  H matvec: sliced-ELL kernel {statistics.median(t_k):.4f} ms (turns "
          f"{[round(t, 4) for t in t_k]}, max err vs plain {k2['max_abs_err']:.3e}), "
          f"{type(vdev['H_ell']).__name__} through plain gathers "
          f"{statistics.median(t_p):.4f} ms (turns {[round(t, 4) for t in t_p]}); useful "
          f"bytes {useful / 1e6:.2f} MB = {useful / HBM_BYTES_S * 1e3:.4f} ms at 3.35 TB/s "
          f"({smi})")
    # warm solves with H through the plain gathers, for the routing decision
    # (the vertex graphs read the operator they captured: dropped with it)
    cached["H_ell"] = H_plain
    cached.pop("vertex_graphs")
    plain_runs, plain_res = timed_solves(solver, geom, opts, 3, yk, pell)
    cached["H_ell"] = H
    cached.pop("vertex_graphs")
    # one graphed solve on the restored operator captures its chunk graph
    # again, outside the profiler: phase 22's turns are warm, and a chunk
    # graph captured under the profiler and launched under it again ended
    # one run in an illegal memory access
    solver.compute_distance(geom, opts)
    torch.cuda.synchronize()
    print(f"  warm solves with H through the plain gathers: "
          f"{[round(r['s'], 4) for r in plain_runs]} s, iters "
          f"{[r['stats']['iters'] for r in plain_runs]}, sliced-ELL launches "
          f"{[r['k2'] for r in plain_runs]}, distinct phi "
          f"{len({r['phi'] for r in plain_runs})}, final residual "
          f"{plain_runs[-1]['stats']['residual']:.3e}; against the kernel route's "
          f"{[round(w, 4) for w in warm]} s at {stats['iters']} iters; phi differs by "
          f"{np.linalg.norm(plain_res.phi - res.phi) / np.linalg.norm(res.phi):.2e}")
    return k1_launches, k2


def cloud_phase(smi, dev):
    """knot_dec's vertices as an oriented point cloud, NONE mode; returns
    (the Yukawa kernel's, the sliced-ELL kernel's numbers at this path's
    shapes, each with the two solves' launches)."""
    from shm3d_torch import LevelSetConstraint, SignedHeatOptions, SignedHeatSolver
    from shm3d_torch.geometry import surface
    from shm3d_torch.io.mesh_io import PointCloud, read_geometry
    from shm3d_torch.ops import yukawa as yk
    from shm3d_torch.solve import pell

    mesh = read_geometry(KNOT)
    cloud = PointCloud(mesh.vertices.copy(), surface.vertex_normals(mesh))
    checksum = surface.normals_checksum(cloud.normals)
    check(abs(checksum - JAX_CLOUD_NORMALS) <= 1e-9 * JAX_CLOUD_NORMALS,
          f"the point cloud's normals are the reference script's (checksum {checksum!r})")
    opts = SignedHeatOptions(level_set_constraint=LevelSetConstraint.NONE,
                             disk_cache=False)
    solver = SignedHeatSolver("tet", device=dev)
    yk.KERNEL_LAUNCHES = 0
    pell.KERNEL_LAUNCHES = 0
    runs, res = timed_solves(solver, cloud, opts, 2, yk, pell)
    k1_launches, k2_launches = yk.KERNEL_LAUNCHES, pell.KERNEL_LAUNCHES
    stats = runs[-1]["stats"]
    phi = res.phi
    print(f"point cloud: knot_dec's {cloud.n_points} vertices with area-weighted "
          f"normals, LevelSetConstraint.NONE (float32, refine_steps=1): "
          f"{res.mesh.n_vertices} vertices, {res.mesh.n_tets} tets, conforming "
          f"{res.mesh.conforming}; amg sizes {stats['amg_sizes']}")
    print_solves(runs)
    print(f"  phi negative at {float((phi < 0).mean()):.2%} of the vertices; final f64 "
          f"residual {stats['residual']:.3e} (limit {VERTEX_RESIDUAL_MAX:g}; JAX package "
          f"{JAX_CLOUD_RESIDUAL:.3e}); distinct phi {len({r['phi'] for r in runs})}; "
          f"kernel launches: yukawa {k1_launches}, sliced ELL {k2_launches}")
    check(all(r["stats"]["step3_path"] == "vertex" for r in runs),
          "the point cloud took the vertex path")
    check(res.mesh.n_vertices == JAX_CLOUD_VERTICES, "point-cloud tet mesh size")
    check(bool(np.isfinite(phi).all()) and phi.shape == (res.mesh.n_vertices,),
          "point-cloud phi finite")
    check(phi.min() < 0 < phi.max() and float((phi < 0).mean()) < 0.2,
          "point-cloud phi negative inside, positive in most of the domain")
    check(len({r["phi"] for r in runs}) == 1, "the two point-cloud solves give one phi")
    check(all(r["k1"] == 1 and r["k2"] > 0 for r in runs),
          "every point-cloud solve launched both kernels")
    check(all(r["stats"]["residual"] <= VERTEX_RESIDUAL_MAX for r in runs),
          "point-cloud residual")
    check_phi_bands(res, JAX_CLOUD, "point cloud")
    GRAPH_PATHS["knot_dec point cloud NONE"] = (solver, cloud, opts, TURNS)
    cached = next(iter(solver._impl._cache.values()))
    k1 = k1_at(yk, cached, opts, smi, "point-cloud barycenters")
    k1["launches"] = k1_launches
    H = cached["H_ell"]
    check(isinstance(H, pell.SellMat), "the point cloud's float32 operator is sliced ELL")
    k2 = k2_at(pell, H, 5, smi, "point cloud's S H S")
    k2["launches"] = k2_launches
    return k1, k2


def upgrade_phase(smi, dev):
    """Greedy integration, then the artifact's upgrade to Crouzeix-Raviart,
    on bunny_dec with a temporary disk cache; returns the Yukawa kernel's
    numbers at bunny_dec's barycenters with the four solves' launches (the
    sliced-ELL kernel has no launch here: the face operator is below the
    size at which it is stored paged)."""
    import tempfile

    from shm3d_torch import SignedHeatOptions, SignedHeatSolver
    from shm3d_torch.io.mesh_io import read_geometry
    from shm3d_torch.ops import yukawa as yk
    from shm3d_torch.solve import pell

    geom = read_geometry(BUNNY)
    opts = SignedHeatOptions()
    yk.KERNEL_LAUNCHES = 0
    pell.KERNEL_LAUNCHES = 0
    saved = os.environ.get("SHM3D_CACHE_DIR")
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["SHM3D_CACHE_DIR"] = tmp
        try:
            solver = SignedHeatSolver("tet", device=dev)
            (greedy,), res_g = timed_solves(solver, geom, opts.with_(fast_integration=True),
                                            1, yk, pell)
            (up,), res_up = timed_solves(solver, geom, opts, 1, yk, pell)
            (loaded,), res_l = timed_solves(SignedHeatSolver("tet", device=dev), geom, opts,
                                            1, yk, pell)
            trees = [d for d in os.listdir(tmp) if d.startswith("tree_")]
        finally:
            if saved is None:
                del os.environ["SHM3D_CACHE_DIR"]
            else:
                os.environ["SHM3D_CACHE_DIR"] = saved
    fresh_solver = SignedHeatSolver("tet", device=dev)
    (fresh,), res_f = timed_solves(fresh_solver, geom, opts.with_(disk_cache=False), 1,
                                   yk, pell)
    k1_launches, k2_launches = yk.KERNEL_LAUNCHES, pell.KERNEL_LAUNCHES
    print(f"greedy and mode upgrade: bunny_dec.obj, {res_g.mesh.n_vertices} vertices, "
          f"{res_g.mesh.n_tets} tets, temporary disk cache ({len(trees)} artifact)")
    for name, r in (("greedy (fast_integration=True)", greedy),
                    ("default solve on the greedy-keyed artifact", up),
                    ("fresh solver on the upgraded artifact", loaded),
                    ("fresh solver, disk_cache=False", fresh)):
        st = r["stats"]
        print(f"  {name}: {r['s']:.3f} s, step 3 {st['step3_path']}, yukawa launches "
              f"{r['k1']}, sliced-ELL launches {r['k2']}, phases {json.dumps(st['phases'])}")
    g = res_g.phi
    print(f"  greedy phi min {g.min():.5f} max {g.max():.5f}, 0 at its "
          f"{np.unique(res_g.mesh.src_vertex).size} seeds; upgraded, reloaded and fresh "
          f"CR phi equal bit for bit: "
          f"{up['phi'] == loaded['phi'] == fresh['phi']} ({smi})")
    check(greedy["stats"]["step3_path"] == "greedy" and bool(np.isfinite(g).all()),
          "greedy integration gives a finite phi")
    check(float(np.abs(g[np.unique(res_g.mesh.src_vertex)]).max()) == 0.0
          and g.min() < 0 < g.max(), "greedy phi: 0 at the seeds, both signs")
    check(any("mode upgrade" in p for p in up["stats"]["phases"])
          and up["stats"]["step3_path"] == "crouzeix-raviart",
          "the default solve on the greedy-keyed artifact took the mode-upgrade phase")
    check(not any("mode upgrade" in p for p in loaded["stats"]["phases"])
          and len(trees) == 1, "a fresh solver loads the upgraded artifact")
    check(up["phi"] == fresh["phi"] == loaded["phi"],
          "the upgraded artifact gives a fresh CR solve's phi bit for bit")
    check(all(r["k1"] == 1 for r in (greedy, up, loaded, fresh)),
          "every bunny solve launched the Yukawa kernel")
    check(k2_launches == 0, "no sliced-ELL launch on bunny_dec (nothing of it to hold)")
    k1 = k1_at(yk, next(iter(fresh_solver._impl._cache.values())), opts, smi,
               "bunny_dec barycenters")
    k1["launches"] = k1_launches
    return k1


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
              f"{st.get('correction_iters')}, Gram LU solves {span_s(st, 'Gram lu.solve')}, "
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
    analytic = analytic_rel(res1)
    print(f"  tier {stats['tier']}; default-tier rel-L2 vs |x|-1 {analytic:.6e}")
    check(all(r["stats"]["tier"] == "full-row" for r in runs), "default tier on the full-row tier")
    return dict(rel_l2_fast_tier=rel_fast, rel_l2_default_tier=rel_default,
                refine_rel_res=stats["refine_rel_res"],
                warm_median_s=statistics.median(warm), phi_ref=phi_ref, analytic=analytic)


def tri_gemv_phase(smi, dev, solver, geom, opts) -> dict:
    """The full-row projector's packed-triangle kernel (csrc/tri_gemv.cu) on
    the main path's own factor: T x and T^T x, kernel and plain version,
    against the float64 product, two calls bit for bit; a warm fast-tier
    and a warm default-tier solve launch it once for each product with T
    (``projection.TMAT_PRODUCTS``); a product timed against its bytes bound
    (the triangle and the two vectors at 3.35 TB/s), the plain version and
    torch.mv over the dense square, the cuBLAS product the kernel replaced
    (a yardstick only).  Returns its kernels-line entry."""
    from shm3d_torch.solve import projection as proj

    cached = next(iter(solver._impl._cache.values()))
    f = cached["gram"].tmat
    check(isinstance(f, proj.TriFactor), "the full-row factor is kept as packed tiles")
    m, nb = f.m, -(-f.m // proj.TRI_TILE)
    x = torch.randn(m, generator=torch.Generator(device=dev).manual_seed(5), device=dev)
    dense = proj.tri_unpack(f).contiguous()
    d64, x64 = dense.double(), x.double()
    bound = (proj.TRI_TILE + nb) * TRI_TILE_ROWS_EPS
    errs, same = {}, {}
    for name, trans, mat in (("T x", False, d64), ("T^T x", True, d64.T)):
        exact, scale = mat @ x64, mat.abs() @ x64.abs()
        got, again = proj.tri_gemv_cuda(f, x, trans), proj.tri_gemv_cuda(f, x, trans)
        torch.cuda.synchronize()
        same[name] = bool(torch.equal(got, again))
        for who, y in (("kernel", got), ("plain", proj.tri_gemv_torch(f, x, trans))):
            rel = (y.double() - exact).abs() / scale.clamp_min(1e-300)
            errs[f"{name} {who}"] = float(rel.max())
    del d64, x64
    worst = max(errs.values())
    print(f"packed-triangle kernel: m={m}, {nb} tile rows, {f.tiles.shape[0]} tiles of "
          f"{proj.TRI_TILE}^2 ({f.tiles.numel() * 4 / 1e9:.4f} GB against the square's "
          f"{m * m * 4 / 1e9:.4f} GB); max |y - exact| / (|T| |x|) a row {json.dumps(errs)} "
          f"(bound {bound:.3e}); two calls bit for bit {same}")
    check(worst <= bound, "the packed-triangle kernel and its plain version within the "
                          "float32 rounding bound of the float64 product")
    check(all(same.values()), "two calls of the packed-triangle kernel give the same bits")

    counts = {}
    for tier, o in (("fast", opts), ("default", opts.with_(refine_steps=1))):
        l0, p0 = proj.TRI_GEMV_LAUNCHES, proj.TMAT_PRODUCTS
        solver.compute_distance(geom, o)
        torch.cuda.synchronize()
        counts[tier] = dict(launches=proj.TRI_GEMV_LAUNCHES - l0,
                            products=proj.TMAT_PRODUCTS - p0,
                            iters=solver.last_stats["iters"],
                            correction_iters=solver.last_stats.get("correction_iters"))
    print(f"  warm solves: packed-triangle launches against products with T "
          f"{json.dumps(counts)}")
    check(all(c["launches"] == c["products"] > 0 for c in counts.values()),
          "a warm fast and default solve launch the packed-triangle kernel once a product")
    check(counts["fast"]["products"] == 4 * (4 + 2 * counts["fast"]["iters"]),
          "the fast tier's products: 4 a projection, 4 + 2 an iteration projections")

    nbytes = 4 * (m * (m + 1) // 2) + 2 * 4 * m
    bound_ms = nbytes / HBM_BYTES_S * 1e3
    times = {}
    for name, trans, mat in (("T x", False, dense), ("T^T x", True, dense.T)):
        def kernel():
            return proj.tri_gemv_cuda(f, x, trans)

        def lib():
            return torch.mv(mat, x)
        # in turns: kernel, library, library, kernel
        k1, l1 = time_ms(kernel, 50), time_ms(lib, 50)
        l2, k2 = time_ms(lib, 50), time_ms(kernel, 50)
        times[name] = dict(ms=(k1 + k2) / 2, library_ms=(l1 + l2) / 2,
                           plain_ms=time_ms(lambda: proj.tri_gemv_torch(f, x, trans), 5),
                           roofline_pct=100.0 * bound_ms / ((k1 + k2) / 2),
                           turns_ms=[k1, l1, l2, k2])
    del dense
    torch.cuda.empty_cache()
    ms = sum(t["ms"] for t in times.values()) / 2
    print(f"  a product: {json.dumps(times)}; bound {bound_ms:.4f} ms ({nbytes / 1e9:.4f} GB "
          f"at 3.35 TB/s; the stored tiles {f.tiles.numel() * 4 / 1e9:.4f} GB); "
          f"{100.0 * bound_ms / ms:.1f}% of it ({smi})")
    return {"name": "tri_gemv", "route": "cuda", "source": "shm3d_torch/csrc/tri_gemv.cu",
            "replaces": None, "launches": sum(c["launches"] for c in counts.values()),
            "max_abs_err": worst, "ms": ms,
            "plain_ms": sum(t["plain_ms"] for t in times.values()) / 2,
            "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": sum(t["library_ms"] for t in times.values()) / 2,
            "per_path": {"products": times, "solves": counts}}


def graph_ms(fn, reps: int = 20, replays: int = 5) -> float:
    """Device time of one fn() call: ``reps`` calls captured into one CUDA
    graph, replayed ``replays`` times between two events (the wrapper's
    host time, which a solve's graphs do not pay, left out)."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (reps * replays)
    del g
    return ms


def cycle_launches(n: int, pinned: bool, coarsest: int = 8) -> int:
    """The fused stencil launches of one V-cycle from an n^3 level, n a
    power of two: three a level above the coarsest (pre-smoothing, the
    residual, post-smoothing); at the coarsest the pinned cycle's 40 sweeps
    in one launch, the unpinned cycle's dense pinv none."""
    levels = 0
    while n > coarsest and n % 2 == 0:
        levels, n = levels + 1, n // 2
    return 3 * levels + (1 if pinned else 0)


def krylov_launches(iters: int, cycle: int) -> int:
    """``krylov.cg_run`` and ``krylov.minres_run``: the setup one Laplacian
    and two V-cycles (CG: M r and M b; MINRES: M r1 and the right-hand
    side's preconditioned norm), an iteration one of each."""
    return 1 + 2 * cycle + iters * (1 + cycle)


def expected_stencil(st, n: int, path: str, pinned: bool) -> int:
    """The fused stencil launches a warm one-device grid solve makes, from
    its stats: its Step 3 (``path``: "krylov", projected CG or MINRES on the
    KKT system; "hostproj", the host-projected loop, whose u starts at 0, so
    no Laplacian before its first V-cycle; "wavefront", none), then, where
    the float64 defect correction ran (refine_mode "pair"), a float64
    Laplacian a defect and each correction solve's projected CG on the
    pinned V-cycle."""
    cycle = cycle_launches(n, pinned)
    if path == "krylov":
        step3 = krylov_launches(st["iters"], cycle)
    elif path == "hostproj":
        step3 = cycle + st["iters"] * (1 + cycle)
    else:
        step3 = 0
    corrections = st.get("correction_iters") or []
    return (step3 + len(st.get("refine_pass_rels") or [])
            + sum(krylov_launches(k, cycle_launches(n, True)) for k in corrections))


def stencil_path(name: str, runs, n: int, path: str, pinned: bool) -> None:
    """Record in STENCIL_PATHS, print and check the fused stencil launches
    of a path's one-device solves (``runs``: their stats) against
    ``expected_stencil``; a solve that captured a graph is left out (its
    capture's warm-up runs a body once more), and one at least must be
    warm."""
    warm = [st for st in runs if st["counters"][CAPTURES_COUNTER] == 0]
    got = [st["counters"][STENCIL_COUNTER] for st in warm]
    want = [expected_stencil(st, n, path, pinned) for st in warm]
    STENCIL_PATHS[name] = dict(launches=sum(got), expected=sum(want), per_solve=got,
                               iters=[st.get("iters") for st in warm])
    print(f"  stencil launches, {name}: {got} in {len(warm)} warm solves of {len(runs)}, "
          f"expected {want} ({path}, {'pinned' if pinned else 'unpinned'} V-cycle from "
          f"{n}^3, {cycle_launches(n, pinned)} launches)")
    check(len(warm) > 0 and got == want,
          f"{name}: the warm solves' stencil launches as their iterations give")


def mg_stencil_phase(smi, dev, solver, geom, opts) -> dict:
    """The V-cycle's fused stencil kernels (csrc/mg_stencil.cu) on the main
    path's pin masks: each op at 128^3 and the 8^3 level's 40 sweeps in one
    launch, bit for bit the plain op chain, timed in a CUDA graph against
    its bytes bound and the plain chain; one pinned V-cycle at 128^3, plain
    against fused, in a graph; ``STENCIL_LAUNCHES`` over a warm fast-tier
    and default-tier solve against the count their iterations give.
    Returns its kernels-line entry."""
    from shm3d_torch.ops import stencil
    from shm3d_torch.solve import multigrid as mg

    cached = next(iter(solver._impl._cache.values()))
    pins = cached["pin_masks"]
    n, cell = cached["grid"].n, float(cached["grid"].cell_size)
    gen = torch.Generator(device=dev).manual_seed(11)
    # STENCIL_SETS input sets of (u, b, mask), taken in turn, so that a
    # timed launch finds its inputs in device memory and not in the 50 MB L2
    sets = [(torch.randn((n, n, n), generator=gen, device=dev),
             torch.randn((n, n, n), generator=gen, device=dev), pins[0].clone())
            for _ in range(STENCIL_SETS)]
    diag = mg._H_diag(cell)

    def in_turn(fn):
        turn = itertools.cycle(sets)
        return lambda: fn(*next(turn))

    ops = {
        # name: (kernel, plain chain, level-sized arrays read and written)
        "jacobi sweep": (
            lambda u, b, m: mg.stencil_cuda("jacobi", u, b, cell, m),
            lambda u, b, m: mg._jacobi(u, b, cell, diag, 1, m * (6.0 / (cell * cell))), 4),
        "jacobi sweep from zero": (
            lambda u, b, m: mg.stencil_cuda("jacobi", None, b, cell, m),
            lambda u, b, m: mg._jacobi(torch.zeros_like(b), b, cell, diag, 1,
                                       m * (6.0 / (cell * cell))), 3),
        "residual": (
            lambda u, b, m: mg.stencil_cuda("residual", u, b, cell, m),
            lambda u, b, m: b - mg._Hp_apply(u, cell, m * (6.0 / (cell * cell))), 4),
        "laplacian": (
            lambda u, b, m: mg.stencil_cuda("laplacian", u, None, cell),
            lambda u, b, m: stencil.laplacian_apply(u, cell), 2),
    }
    res, same = {}, {}
    for name, (kern, plain, arrays) in ops.items():
        same[name] = bool(torch.equal(kern(*sets[0]), plain(*sets[0])))
        bound_us = arrays * 4 * n ** 3 / HBM_BYTES_S * 1e6
        k1, p1 = graph_ms(in_turn(kern)), graph_ms(in_turn(plain))
        p2, k2 = graph_ms(in_turn(plain)), graph_ms(in_turn(kern))
        us = (k1 + k2) / 2 * 1e3
        res[name] = dict(us=us, plain_us=(p1 + p2) / 2 * 1e3, bound_us=bound_us,
                         roofline_pct=100.0 * bound_us / us, turns_us=[k1 * 1e3, p1 * 1e3,
                                                                       p2 * 1e3, k2 * 1e3])
    u, b, mask = sets[0]
    del sets
    # float64, as the float64 grid, the eager float64 Laplacian and a
    # float64 pinned solve run it: each op at 128^3 on the pins built in
    # float64 from the main path's pinned rows, bit for bit its plain chain
    pins64 = mg.build_pin_masks(cached["pin_nodes8"], (n, n, n), torch.float64)
    u64, b64 = (torch.randn((n, n, n), generator=gen, device=dev, dtype=torch.float64)
                for _ in range(2))
    for name, (kern, plain, _) in ops.items():
        same[f"{name} float64"] = bool(torch.equal(kern(u64, b64, pins64[0]),
                                                   plain(u64, b64, pins64[0])))
    # the coarsest level: 40 sweeps from zero in one launch
    m8 = pins[-1]
    n8, cell8 = int(m8.shape[0]), cell * 2 ** (len(pins) - 1)
    b8 = torch.randn((n8, n8, n8), generator=gen, device=dev)
    l0 = mg.STENCIL_LAUNCHES
    got8 = mg.stencil_cuda("jacobi", None, b8, cell8, m8, 40)
    one_launch = mg.STENCIL_LAUNCHES - l0
    w8 = m8 * (6.0 / (cell8 * cell8))
    same["coarsest 40 sweeps"] = bool(torch.equal(
        got8, mg._jacobi(torch.zeros_like(b8), b8, cell8, mg._H_diag(cell8), 40, w8)))
    m8_64 = pins64[-1]
    b8_64 = b8.to(torch.float64)
    same["coarsest 40 sweeps float64"] = bool(torch.equal(
        mg.stencil_cuda("jacobi", None, b8_64, cell8, m8_64, 40),
        mg._jacobi(torch.zeros_like(b8_64), b8_64, cell8, mg._H_diag(cell8), 40,
                   m8_64 * (6.0 / (cell8 * cell8)))))
    c_us = graph_ms(lambda: mg.stencil_cuda("jacobi", None, b8, cell8, m8, 40)) * 1e3
    c_plain_us = graph_ms(lambda: mg._jacobi(torch.zeros_like(b8), b8, cell8, mg._H_diag(cell8),
                                             40, m8 * (6.0 / (cell8 * cell8))), reps=2) * 1e3
    res["coarsest 40 sweeps"] = dict(us=c_us, plain_us=c_plain_us, n=n8, launches=one_launch)
    # whole V-cycles at 128^3, fused and plain: pinned (the projected CG's)
    # and unpinned (MINRES's, the host-projected loop's), float32 and
    # float64; the pinned float32 one timed, each in a graph
    cycles = {"pinned V-cycle": (b, pins), "unpinned V-cycle": (b, None),
              "pinned V-cycle float64": (b64, pins64), "unpinned V-cycle float64": (b64, None)}
    fused_vc = {k: mg.v_cycle(x, cell, pins=p) for k, (x, p) in cycles.items()}
    real_fused = mg.fused
    vc_fused_us = graph_ms(lambda: mg.v_cycle(b, cell, pins=pins), reps=5) * 1e3
    mg.fused = lambda t: False
    try:
        plain_vc = {k: mg.v_cycle(x, cell, pins=p) for k, (x, p) in cycles.items()}
        vc_plain_us = graph_ms(lambda: mg.v_cycle(b, cell, pins=pins), reps=5) * 1e3
    finally:
        mg.fused = real_fused
    for k in cycles:
        same[k] = bool(torch.equal(fused_vc[k], plain_vc[k]))
    res["pinned V-cycle"] = dict(us=vc_fused_us, plain_us=vc_plain_us, levels=len(pins))
    del u, b, u64, b64, fused_vc, plain_vc, cycles
    torch.cuda.empty_cache()
    print(f"fused stencil kernels at {n}^3 (float32, the main path's level-0 mask, cell "
          f"{cell:.6g}): {json.dumps(res)}; bit for bit the plain ops (float32, and float64 "
          f"on its own pins) {same} ({smi})")
    check(all(same.values()), "the fused stencil kernels equal their plain op chains bit for bit")
    check(one_launch == 1, "the coarsest level's 40 sweeps in one launch")

    counts, stats = {}, {}
    for tier, o in (("fast", opts), ("default", opts.with_(refine_steps=1))):
        l0 = mg.STENCIL_LAUNCHES
        solver.compute_distance(geom, o)
        torch.cuda.synchronize()
        stats[tier] = dict(solver.last_stats)
        counts[tier] = dict(launches=mg.STENCIL_LAUNCHES - l0,
                            counter=stats[tier]["counters"][STENCIL_COUNTER])
    check(all(c["launches"] == c["counter"] for c in counts.values()),
          "the solve's counters carry STENCIL_LAUNCHES")
    check(cycle_launches(n, True) == 3 * (len(pins) - 1) + 1,
          "a pinned V-cycle's launches: three a level above the coarsest, one there")
    for tier in counts:
        stencil_path(f"sphere52k-128 {tier} tier", [stats[tier]], n, "krylov", True)
    st = stats["default"]
    krylov = st["iters"] + sum(st.get("correction_iters") or [])
    print(f"  default tier: {st['iters']} + {st.get('correction_iters')} iterations, "
          f"{len(st.get('refine_pass_rels') or [])} float64 defects")
    check(stats["fast"]["iters"] == EAGER_MAIN[0] and krylov == DEFAULT_KRYLOV_ITERS,
          f"the fast tier's {EAGER_MAIN[0]} and the default tier's {DEFAULT_KRYLOV_ITERS} iterations")
    kern = [r for k, r in res.items() if "bound_us" in r]
    # the launches of the later phases' solves join these in main
    return {"name": "mg_stencil", "route": "cuda", "source": "shm3d_torch/csrc/mg_stencil.cu",
            "replaces": None, "launches": one_launch,
            "max_abs_err": 0.0, "ms": sum(r["us"] for r in kern) / 1e3,
            "plain_ms": sum(r["plain_us"] for r in kern) / 1e3,
            "bound_ms": sum(r["bound_us"] for r in kern) / 1e3, "bound_by": "bytes",
            "library_ms": None, "per_path": {"ops": res, "solves": STENCIL_PATHS}}


@contextlib.contextmanager
def no_plain_yukawa(yk):
    """K1's plain versions replaced by stubs that fail the run: a solve on
    the card must launch the kernels."""
    names = ("yukawa_field_torch", "yukawa_partials_torch", "yukawa_merge_torch")
    saved = {n: getattr(yk, n) for n in names}

    def refuse(name):
        def stub(*args, **kwargs):
            check(False, f"a solve on the card reached the plain {name}")
        return stub

    for n in names:
        setattr(yk, n, refuse(n))
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(yk, n, f)


def shard_blocks(q, P):
    """The row blocks ``farfield._rowsharded`` launches K1 on."""
    from shm3d_torch.ops.farfield import row_blocks

    step = row_blocks(q.shape[0], P, q.dtype)
    return [q[k * step:(k + 1) * step] for k in range(P) if k * step < q.shape[0]]


def plain_ring(yk, q, pts, vecs, lam, P):
    """The ring's arithmetic through K1's plain versions: per query shard
    the partials of every source shard, with the kernel's chunking, merged
    in the sources' home order."""
    pad = -pts.shape[0] % P
    sp = torch.cat([pts, pts.new_full((pad, 3), yk._FAR)]).chunk(P)
    sv = torch.cat([vecs, vecs.new_zeros((pad, 3))]).chunk(P)
    out = []
    for qi in q.chunk(P):
        parts = [yk.yukawa_partials_torch(qi, p.contiguous(), v.contiguous(), lam,
                                          yk.yukawa_chunk_len(qi.shape[0], p.shape[0], q.device))
                 for p, v in zip(sp, sv)]
        out.append(yk.yukawa_merge_torch(torch.cat(parts)))
    return torch.cat(out)


def mesh_phase(smi, dev, sfu, geom, opts, main):
    """The grid domain on a device mesh of four shards of the one card;
    returns the K1 entries of the mesh solves (``grid_mesh``) and of the
    ring (``grid_ring``) for the kernels line.  ``main``: the single-device
    main path's solver, phi, iterations and warm median, and the default
    tier's reference phi and warm median."""
    import tempfile

    from shm3d_torch import SignedHeatSolver
    from shm3d_torch.ops import stencil
    from shm3d_torch.ops import yukawa as yk
    from shm3d_torch.ops.farfield import DeviceShellPlan
    from shm3d_torch.parallel import device_mesh, slab, yukawa_field_ring
    from shm3d_torch.solve import multigrid, pell
    from shm3d_torch.solvers.grid import _node_positions_device

    mesh4 = device_mesh(devices=[dev] * 4)
    mesh22 = device_mesh(devices=[dev] * 4, n_slices=2)
    cached = next(iter(main["solver"]._impl._cache.values()))
    grid = cached["grid"]
    n, cell = grid.n, float(grid.cell_size)
    print(f"mesh: {len(mesh4)} shards of {dev} ({smi}); one card runs repeated-device "
          f"meshes only, so this shows the decomposition's cost on one card, not scaling")

    # --- slab operators bitwise equal to the single-device ones, f32 128^3
    rng = np.random.default_rng(7)
    u = torch.as_tensor(rng.standard_normal((n, n, n)), dtype=torch.float32, device=dev)
    lap_eq = torch.equal(torch.cat(slab.laplacian_apply(list(u.chunk(4)), cell)),
                         stencil.laplacian_apply(u, cell))
    pins = cached["pin_masks"]
    spins = multigrid.build_slab_pin_masks(cached["pin_nodes8"], n, mesh4, torch.float32)
    masks_eq = len(pins) == len(spins) and all(
        torch.equal(a, b if isinstance(b, torch.Tensor) else torch.cat(b))
        for a, b in zip(pins, spins))
    e1 = multigrid.v_cycle(u, cell, pins=pins)
    e4 = torch.cat(multigrid.v_cycle_slabs(list(u.chunk(4)), cell, pins=spins))
    vc_eq = torch.equal(e1, e4)
    t_single = time_ms(lambda: multigrid.v_cycle(u, cell, pins=pins), 5)
    t_slab = time_ms(lambda: multigrid.v_cycle_slabs(list(u.chunk(4)), cell, pins=spins), 5)
    level, n_level = multigrid.slab_gather_level(n, 4)
    print(f"  slab Laplacian bitwise equal {lap_eq}; slab pin masks equal {masks_eq}; pin-aware "
          f"slab V-cycle bitwise equal {vc_eq} (gathered at level {level}, {n_level}^3); "
          f"V-cycle {t_single:.3f} ms on one device, {t_slab:.3f} ms on 4 slabs ({smi})")
    check(lap_eq, "slab Laplacian bitwise equal to the single-device one at 128^3")
    check(masks_eq and vc_eq, "pin-aware slab V-cycle bitwise equal to the single-device one")
    del u, e1, e4

    # --- the dense ring at 128^3
    pts, vecs = cached["points"], cached["vectors"]
    lam = float(np.sqrt(1.0 / (opts.t_coef * cached["spacing"] ** 2)))
    q = _node_positions_device(grid.bbox_min, cell, n, torch.float32, dev)
    Q, S = int(q.shape[0]), int(pts.shape[0])
    yk.PARTIAL_LAUNCHES = yk.MERGE_LAUNCHES = 0
    with no_plain_yukawa(yk):
        ring1 = yukawa_field_ring(q, pts, vecs, lam, mesh4).gather()
        ring2 = yukawa_field_ring(q, pts, vecs, lam, mesh22).gather()
        torch.cuda.synchronize()
    ring_launches = dict(partial=yk.PARTIAL_LAUNCHES, merge=yk.MERGE_LAUNCHES)
    one = yk.yukawa_field_cuda(q, pts, vecs, lam)
    plain = plain_ring(yk, q, pts, vecs, lam, 4)
    torch.cuda.synchronize()
    err_one = (ring1 - one).abs().max().item()
    err_plain = (ring1 - plain).abs().max().item()
    ring_eq = torch.equal(ring1, ring2)
    ring_ms = time_ms(lambda: yukawa_field_ring(q, pts, vecs, lam, mesh4), 2)
    one_ms = time_ms(lambda: yk.yukawa_field_cuda(q, pts, vecs, lam), 2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain_ring(yk, q, pts, vecs, lam, 4)
    torch.cuda.synchronize()
    ring_plain_ms = (time.perf_counter() - t0) * 1e3
    ring_bound = pair_bound_ms(Q * S, Q, S, sfu)
    print(f"  ring Q={Q} S={S} on 4 shards: {ring_launches['partial']} partial + "
          f"{ring_launches['merge']} merge launches in the 1-D and 2-D rings; max err vs K1 on one "
          f"device {err_one:.3e}, vs the plain ring {err_plain:.3e} (tol {DIR_TOL:g}); 1-D and 2 x 2 "
          f"bitwise equal {ring_eq}; {ring_ms:.3f} ms (one device {one_ms:.3f} ms, plain "
          f"{ring_plain_ms:.1f} ms) against its SFU bound {ring_bound:.3f} ms "
          f"(pair_bound_ms; {100 * ring_bound / ring_ms:.1f}%; {smi})")
    check(ring_launches == dict(partial=32, merge=8), "the rings launched 16 partial + 4 merge each")
    check(max(err_one, err_plain) <= DIR_TOL, "the ring within 1e-4 of K1 on one device")
    check(ring_eq, "the 1-D and 2 x 2 rings give one field bit for bit")
    del ring1, ring2, one, plain, q
    torch.cuda.empty_cache()

    # --- the main path on the meshes (a temporary disk cache shares the
    # host precompute between the phase's solvers)
    saved = os.environ.get("SHM3D_CACHE_DIR")
    mopts = opts.with_(disk_cache=True)
    runs, results = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["SHM3D_CACHE_DIR"] = tmp
        try:
            yk.KERNEL_LAUNCHES = 0
            with no_plain_yukawa(yk):
                for name, mesh in (("1x4", mesh4), ("2x2", mesh22)):
                    solver = SignedHeatSolver("grid", mesh=mesh)
                    runs[name], results[name] = timed_solves(solver, geom, mopts, 4, yk, pell)
                    runs[name + " solver"] = solver
            mesh_k1 = yk.KERNEL_LAUNCHES
            check(mesh_k1 > 0, "the mesh solves launched K1")
            with no_plain_yukawa(yk):
                profile_solve("warm fast-tier solve on 4 shards",
                              lambda: runs["1x4 solver"].compute_distance(geom, mopts),
                              statistics.median(r["s"] for r in runs["1x4"][1:]), smi,
                              names=GRID_KERNELS)
                yk.PARTIAL_LAUNCHES = yk.MERGE_LAUNCHES = 0
                (dense,), res_dense = timed_solves(
                    runs["2x2 solver"], geom, mopts.with_(step1_method="dense"), 1, yk, pell)
                dense_launches = dict(partial=yk.PARTIAL_LAUNCHES, merge=yk.MERGE_LAUNCHES)
                default, res_def = timed_solves(runs["1x4 solver"], geom,
                                                mopts.with_(refine_steps=1), 2, yk, pell)
            fb_solver = SignedHeatSolver("grid", mesh=device_mesh(devices=[dev] * 3))
            (fb,), res_fb = timed_solves(fb_solver, geom, mopts, 1, yk, pell)
        finally:
            if saved is None:
                del os.environ["SHM3D_CACHE_DIR"]
            else:
                os.environ["SHM3D_CACHE_DIR"] = saved
    phi_ref, phi1 = main["phi_ref"], main["phi"]
    nrm_ref, nrm1 = float(np.linalg.norm(phi_ref)), float(np.linalg.norm(phi1))
    for name in ("1x4", "2x2"):
        rr = runs[name]
        st = rr[-1]["stats"]
        res = results[name]
        rel_ref = float(np.linalg.norm(res.phi - phi_ref)) / nrm_ref
        rel_one = float(np.linalg.norm(res.phi - phi1)) / nrm1
        warm = [r["s"] for r in rr[1:]]
        print_grid_solves(f"mesh {name}", rr)
        print(f"  mesh {name}: warm {[round(w, 4) for w in warm]} s, median "
              f"{statistics.median(warm):.4f} s (one device {main['warm_median_s']:.4f} s); iters "
              f"{st['iters']} (one device {main['iters']}); K1 launches a solve "
              f"{[r['k1'] for r in rr]}; mem_peak_mb {st.get('mem_peak_mb', 0):.1f}; mesh "
              f"{json.dumps(st['mesh'])}; rel-L2 vs the reference {rel_ref:.6e}, vs the "
              f"single-device phi {rel_one:.6e}; distinct phi {len({r['phi'] for r in rr})} ({smi})")
        check(all(r["stats"]["mesh"]["fallback"] is False and r["stats"]["tier"] == "full-row"
                  for r in rr), f"mesh {name}: z-slabs on the full-row tier")
        check(all(abs(r["stats"]["iters"] - main["iters"]) <= 2 for r in rr),
              f"mesh {name}: iterations within 2 of the single-device {main['iters']}")
        check(rel_ref <= FAST_TIER_REL_L2_MAX, f"mesh {name}: within 1e-5 of the reference")
        check(rel_one <= FAST_TIER_REL_L2_MAX, f"mesh {name}: within 1e-5 of the single-device phi")
        check(len({r["phi"] for r in rr}) == 1, f"mesh {name}: four solves give one phi")
        check(all(r["k1"] == 8 for r in rr), f"mesh {name}: K1 twice on each of 4 shards a solve")
        check(torch.equal(res.Y, main["Y"]),
              f"mesh {name}: the Step-1 field bitwise equal to the single-device one")
    check(np.array_equal(results["2x2"].phi, results["1x4"].phi),
          "the 2 x 2 mesh's phi bitwise equal to the 1 x 4 mesh's")
    analytic = analytic_rel(res_dense)
    print(f"  dense Step 1 on the 2 x 2 ring through GridSolver: {dense['s']:.4f} s, "
          f"{dense_launches['partial']} partial + {dense_launches['merge']} merge launches, iters "
          f"{dense['stats']['iters']}, rel-L2 vs |x|-1 {analytic:.6e} (JAX package, shell: "
          f"{JAX_ANALYTIC_REL_L2:.6e}; {smi})")
    check(dense_launches == dict(partial=16, merge=4) and dense["k1"] == 0,
          "the dense mesh solve ran Step 1 on the ring's kernels")
    check(abs(analytic - JAX_ANALYTIC_REL_L2) / JAX_ANALYTIC_REL_L2 <= ANALYTIC_BAND,
          "dense mesh solve's analytic rel-L2 within 10% of the JAX package's")
    rel_def = float(np.linalg.norm(res_def.phi - phi_ref)) / nrm_ref
    print_grid_solves("mesh 1x4 default-tier", default)
    print(f"  mesh 1x4 default tier: {[round(r['s'], 4) for r in default]} s (one device warm "
          f"{main['default_warm_s']:.4f} s), rel-L2 vs the reference {rel_def:.6e} (one device "
          f"1.469e-10; limit 1e-8), distinct phi {len({r['phi'] for r in default})} ({smi})")
    check(rel_def <= 1e-8, "mesh default tier within 1e-8 of the reference")
    check(len({r["phi"] for r in default}) == 1, "two mesh default-tier solves give one phi")
    fb_mesh = fb["stats"]["mesh"]
    print(f"  3 shards at {n}^3: {fb['s']:.4f} s, mesh {json.dumps(fb_mesh)}, phi bitwise equal "
          f"to the single-device {np.array_equal(res_fb.phi, phi1)}")
    check(fb_mesh["fallback"] is True and np.array_equal(res_fb.phi, phi1),
          "3 shards fall back to the single-device path with its phi")

    # --- K1 at the mesh solves' launch shapes (4 row blocks of each launch,
    # each with the source chunks of the whole launch)
    plan = next(v for v in cached.values() if isinstance(v, DeviceShellPlan))
    launches = [(b, yk.yukawa_chunk_len(q.shape[0], S, dev))
                for q in (plan.shell_pos, plan.coarse_pos) for b in shard_blocks(q, 4)]
    blocks = [b for b, _ in launches]
    errs = []
    for b, c in launches:
        got = yk.yukawa_field_cuda(b, pts, vecs, lam, chunk=c)
        errs.append((got - yk.yukawa_field_torch(b, pts, vecs, lam)).abs().max().item())
    ms = sum(time_ms(lambda: yk.yukawa_field_cuda(b, pts, vecs, lam, chunk=c), 5)
             for b, c in launches)
    plain_ms = sum(time_ms(lambda: yk.yukawa_field_torch(b, pts, vecs, lam), 1) for b in blocks)
    bound = sum(pair_bound_ms(int(b.shape[0]) * S, int(b.shape[0]), S, sfu) for b in blocks)
    print(f"  K1 at the mesh solve's {len(blocks)} launches ({[int(b.shape[0]) for b in blocks]} queries): "
          f"{ms:.3f} ms a solve (one device {main['k1_ms']:.3f} ms) against its SFU bound "
          f"{bound:.3f} ms ({100 * bound / ms:.1f}%); max err vs plain {max(errs):.3e}; plain "
          f"{plain_ms:.1f} ms ({smi})")
    check(max(errs) <= DIR_TOL, "K1 at the mesh's row blocks within tolerance")
    grid_mesh = dict(launches=mesh_k1, max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                     bound_ms=bound)
    grid_ring = dict(launches=sum(ring_launches.values()) + sum(dense_launches.values()),
                     max_abs_err=err_plain, ms=ring_ms, plain_ms=ring_plain_ms,
                     bound_ms=ring_bound)
    return grid_mesh, grid_ring


@contextlib.contextmanager
def no_plain_sell(pell):
    """K2's plain version replaced by a stub that fails the run: a mesh
    solve on the card must launch the kernel on every row block."""
    saved = pell.sell_matvec_torch

    def stub(*args, **kwargs):
        check(False, "a solve on the card reached the plain sell_matvec_torch")

    pell.sell_matvec_torch = stub
    try:
        yield
    finally:
        pell.sell_matvec_torch = saved


def k2_blocks_at(pell, A1, A4, seed, smi, what):
    """K2 on the row blocks of a mesh's operator ``A4`` against one launch
    over the same operator ``A1`` (bitwise) and the plain version; the four
    block launches and the one launch timed in turns.  Returns the numbers
    for the kernels line."""
    from shm3d_torch.parallel import RowSharded

    check(isinstance(A4, RowSharded) and len(A4.blocks) == 4,
          f"the mesh's {what} split into 4 sliced-ELL row blocks")
    x = torch.as_tensor(np.random.default_rng(seed).standard_normal(A1.n_cols),
                        dtype=torch.float32, device=A1.vals.device)
    before = pell.KERNEL_LAUNCHES
    y4 = pell.apply(A4, x)
    per_matvec = pell.KERNEL_LAUNCHES - before
    y1 = pell.sell_matvec_cuda(A1, x)
    ref = pell.sell_matvec_torch(A1, x)
    torch.cuda.synchronize()
    equal = torch.equal(y4, y1)
    err = (y4 - ref).abs().max().item()
    rel = err / max(ref.abs().max().item(), 1e-30)
    lib = sell_csr(pell, A1)
    t_b, t_1 = [], []
    for _ in range(2):  # turns: blocks, one, one, blocks
        t_b.append(time_ms(lambda: [pell.sell_matvec_cuda(b, x) for b in A4.blocks], 50))
        t_1.append(time_ms(lambda: pell.sell_matvec_cuda(A1, x), 50))
        t_1.append(time_ms(lambda: pell.sell_matvec_cuda(A1, x), 50))
        t_b.append(time_ms(lambda: [pell.sell_matvec_cuda(b, x) for b in A4.blocks], 50))
    t_apply = time_ms(lambda: pell.apply(A4, x), 50)
    host = {name: host_us(fn, 200) for name, fn in (
        ("split", lambda: pell.apply(A4, x)), ("one", lambda: pell.sell_matvec_cuda(A1, x)))}
    t_lib = time_ms(lambda: lib @ x, 50)
    t_plain = time_ms(lambda: pell.sell_matvec_torch(A1, x), 5)
    nonzeros = int((A1.vals != 0).sum())
    bound_ms = (8 * nonzeros + 4 * (A1.n_cols + A1.n_rows)) / HBM_BYTES_S * 1e3
    blocks_ms = statistics.median(t_b)
    print(f"  K2 on the row blocks of {what} ({A4.block_rows} rows): {per_matvec} launches a "
          f"matvec, bitwise equal to one launch {equal}, max err vs plain {err:.3e} (relative "
          f"{rel:.3e}); the {len(A4.blocks)} block launches {blocks_ms:.4f} ms (turns "
          f"{[round(t, 4) for t in t_b]}), with the copy of x and the concatenation "
          f"{t_apply:.4f} ms, one launch {statistics.median(t_1):.4f} ms (turns "
          f"{[round(t, 4) for t in t_1]}), useful bytes at 3.35 TB/s {bound_ms:.4f} ms "
          f"({100 * bound_ms / blocks_ms:.1f}% for the blocks), cuSPARSE CSR {t_lib:.4f} ms, "
          f"plain {t_plain:.3f} ms; host time a product {host['split']:.1f} us split, "
          f"{host['one']:.1f} us one launch ({smi})")
    check(per_matvec == len(A4.blocks), f"K2 launched once a block on {what}")
    check(equal, f"K2's row blocks of {what} bitwise equal to one launch")
    check(rel <= PELL_RTOL, f"K2's row blocks of {what} within tolerance of the plain version")
    return dict(max_abs_err=err, ms=blocks_ms, plain_ms=t_plain, bound_ms=bound_ms,
                library_ms=t_lib)


def tet_mesh_phase(smi, dev, sfu, one):
    """The tet domain on a device mesh of four shards of the one card (1 x 4
    and 2 x 2) on knot_dec; returns the K1 entry of its ring (``tet_ring``)
    and the K2 entry of its row blocks (``tet_mesh``).  ``one``: the
    single-device tet phase's warm median, iterations, profile and launches."""
    import tempfile

    from shm3d_torch import SignedHeatOptions
    from shm3d_torch.io.mesh_io import read_geometry
    from shm3d_torch.ops import yukawa as yk
    from shm3d_torch.parallel import device_mesh, rows, yukawa_field_ring
    from shm3d_torch.solve import pell
    from shm3d_torch.tet.solver import SignedHeatTetSolver
    from shm3d_torch.utils.timing import PhaseTimer

    geom = read_geometry(KNOT)
    opts = SignedHeatOptions(disk_cache=True)
    vopts = opts.with_(use_crouzeix_raviart=False)
    mesh4 = device_mesh(devices=[dev] * 4)
    mesh22 = device_mesh(devices=[dev] * 4, n_slices=2)
    print(f"tet mesh: knot_dec.obj on {len(mesh4)} shards of {dev} ({smi}); one card runs "
          f"repeated-device meshes only, so this shows the decomposition's cost, not scaling")
    saved = os.environ.get("SHM3D_CACHE_DIR")
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["SHM3D_CACHE_DIR"] = tmp
        try:
            # the host artifact, built once by one device: the CR family,
            # then the vertex family by the mode upgrade
            t0 = time.perf_counter()
            single = SignedHeatTetSolver(device=dev)
            res1 = single.compute_distance(geom, opts)
            single.compute_distance(geom, vopts)
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
            yk.KERNEL_LAUNCHES = yk.PARTIAL_LAUNCHES = yk.MERGE_LAUNCHES = 0
            pell.KERNEL_LAUNCHES = 0
            rows.ROW_BLOCK_LAUNCHES = rows.BROADCASTS = 0
            with no_plain_yukawa(yk), no_plain_sell(pell), eager_allowed():
                s4 = SignedHeatTetSolver(mesh=mesh4)
                runs4, res4 = timed_solves(s4, geom, opts, 3, yk, pell)
                s22 = SignedHeatTetSolver(mesh=mesh22)
                runs22, res22 = timed_solves(s22, geom, opts, 1, yk, pell)
                (vrun,), vres = timed_solves(s4, geom, vopts, 1, yk, pell)
            launches = dict(partial=yk.PARTIAL_LAUNCHES, merge=yk.MERGE_LAUNCHES,
                            fused=yk.KERNEL_LAUNCHES, k2=pell.KERNEL_LAUNCHES,
                            blocks=rows.ROW_BLOCK_LAUNCHES, broadcasts=rows.BROADCASTS)
            trees = [d for d in os.listdir(tmp) if d.startswith("tree_")]
        finally:
            if saved is None:
                del os.environ["SHM3D_CACHE_DIR"]
            else:
                os.environ["SHM3D_CACHE_DIR"] = saved
    n_solves = len(runs4) + len(runs22) + 1
    st, vst = runs4[-1]["stats"], vrun["stats"]
    warm = [r["s"] for r in runs4[1:]]
    print(f"  host artifact by one device (CR solve + vertex upgrade) {build_s:.2f} s, "
          f"{len(trees)} artifact; the mesh solvers read it")
    for name, rr in (("1x4", runs4), ("2x2", runs22)):
        for k, r in enumerate(rr):
            rs = r["stats"]
            print(f"  mesh {name} CR solve {k}: {r['s']:.3f} s, face iters {rs['iters']} "
                  f"(one device {one['iters']}), f64 residual passes {rs['refine_pass_rels']}, "
                  f"projection {rs['proj_iters']} iters {rs['proj_residual']:.3e}, K2 launches "
                  f"{r['k2']} (one device {one['k2_per_solve']}), mem_peak_mb "
                  f"{rs['mem_peak_mb']:.1f} (one device {one['mem_peak_mb']:.1f}), phases "
                  f"{json.dumps(rs['phases'])}")
    print(f"  mesh 1x4 warm {[round(w, 4) for w in warm]} s, median {statistics.median(warm):.4f} s "
          f"at {st['iters']} face iterations (one device {one['warm_median_s']:.4f} s at "
          f"{one['iters']}); mesh {json.dumps(st['mesh'])}")
    print(f"  launches in the {n_solves} mesh solves: K1 partial {launches['partial']}, merge "
          f"{launches['merge']}, fused {launches['fused']}; K2 {launches['k2']}; row-block "
          f"products {launches['blocks']} after {launches['broadcasts']} copies of x")
    check(len(trees) == 1, "one host artifact serves one device and the meshes")
    check(all(r["stats"]["step3_path"] == "crouzeix-raviart" for r in runs4 + runs22),
          "the mesh CR solves took the Crouzeix-Raviart path")
    check(len({r["phi"] for r in runs4}) == 1, "the mesh's three CR solves give one phi")
    check(np.array_equal(res22.phi, res4.phi), "the 2 x 2 mesh's phi bitwise equal to 1 x 4's")
    check(launches["partial"] == 16 * n_solves and launches["merge"] == 4 * n_solves
          and launches["fused"] == 0, "every mesh solve ran Step 1 on the ring's kernels")
    check(launches["k2"] > 0 and all(r["k2"] > 0 for r in runs4 + runs22 + [vrun]),
          "every mesh solve launched K2")
    check(all(len(r["stats"]["mesh"]["row_blocks"]["L"]) == 4 for r in runs4 + runs22)
          and len(vst["mesh"]["row_blocks"]["H"]) == 4, "L and S H S split into 4 row blocks")
    for r in runs4 + runs22:
        check(r["stats"]["residual"] <= FACE_RESIDUAL_MAX, "mesh face residual")
        check(r["stats"]["proj_residual"] <= PROJ_RESIDUAL_MAX, "mesh projection residual")
    check(res4.phi.shape == (KNOT_VERTICES,) and bool(np.isfinite(res4.phi).all()),
          "mesh phi finite, one value a vertex")
    check_bands(res4, dict(min=JAX_PHI_MIN, max=JAX_PHI_MAX, mean_abs=JAX_PHI_MEAN_ABS,
                           src_mean_abs=JAX_PHI_MEAN_ABS_SRC), PHI_BANDS, "mesh CR solve")
    print(f"  mesh 1x4 vertex solve: {vrun['s']:.3f} s, iters {vst['iters']}, residual "
          f"{vst['residual']:.3e}, K2 launches {vrun['k2']}, max |phi| at the sources "
          f"{np.abs(vres.phi_at_sources()).max()}, row blocks of H "
          f"{vst['mesh']['row_blocks']['H']}, first AMG level kept whole "
          f"{vst['mesh']['amg_first_whole_level']}, {json.dumps(vst['phases'])}")
    check(vst["step3_path"] == "vertex" and float(np.abs(vres.phi_at_sources()).max()) == 0.0,
          "mesh vertex solve: sources exactly 0")
    check(vst["residual"] <= VERTEX_RESIDUAL_MAX, "mesh vertex residual")
    check_bands(vres, JAX_VERTEX, VERTEX_BANDS, "mesh vertex solve")

    # --- Step 3 given one Y: the single device's field into both
    c1, c4 = (next(iter(sv._cache.values())) for sv in (single, s4))
    Y = torch.as_tensor(res1.Y, dtype=torch.float32, device=dev)
    with no_plain_yukawa(yk), no_plain_sell(pell), eager_allowed():
        cr = [(c["cr_path"].integrate(Y, opts, src_face_components=c["cr_face_components"],
                                      src_face_areas=c["cr_face_areas"]),
               dict(c["cr_path"].last_stats)) for c in (c1, c4)]
        vx = []
        for sv, c in ((single, c1), (s4, c4)):
            sv.last_stats = {}
            vx.append((sv._integrate(Y, c["mesh"], c, vopts, PhaseTimer(dev)),
                       dict(sv.last_stats)))
    keys = ("iters", "residual", "refine_pass_rels", "proj_iters", "proj_residual",
            "proj_refine_pass_rels")
    for what, ((a, sa), (b, sb)) in (("CR", cr), ("vertex", vx)):
        same = np.array_equal(a, b) and all(sa.get(k) == sb.get(k) for k in keys)
        print(f"  Step 3 given one Y, {what}: mesh bitwise equal to one device {same} "
              f"(iters {sa['iters']} / {sb['iters']}, residual passes "
              f"{sa['refine_pass_rels']} / {sb['refine_pass_rels']})")
        check(same, f"the mesh's {what} Step 3 given one Y bitwise equal to one device's")

    # --- K2 on the row blocks, K1's ring at the barycenters
    k2_l = k2_blocks_at(pell, c1["cr_path"].arrays["L"], c4["cr_path"].arrays["L"], 8, smi,
                        "the face operator L")
    k2_h = k2_blocks_at(pell, c1["H_ell"], c4["H_ell"], 9, smi, "S H S")
    q, pts, vecs = c1["barys"], c1["points"], c1["vectors"]
    lam = float(np.sqrt(1.0 / (opts.t_coef * c1["spacing"] ** 2)))
    Q, S = int(q.shape[0]), int(pts.shape[0])
    yk.PARTIAL_LAUNCHES = yk.MERGE_LAUNCHES = 0
    with no_plain_yukawa(yk):
        ring4 = yukawa_field_ring(q, pts, vecs, lam, mesh4).gather()
        ring22 = yukawa_field_ring(q, pts, vecs, lam, mesh22).gather()
        torch.cuda.synchronize()
    ring_launches = dict(partial=yk.PARTIAL_LAUNCHES, merge=yk.MERGE_LAUNCHES)
    one_launch = yk.yukawa_field_cuda(q, pts, vecs, lam)
    plain = plain_ring(yk, q, pts, vecs, lam, 4)
    torch.cuda.synchronize()
    err_one = (ring4 - one_launch).abs().max().item()
    err_plain = (ring4 - plain).abs().max().item()
    t_r, t_1 = [], []
    for _ in range(2):  # turns: ring, one, one, ring
        t_r.append(time_ms(lambda: yukawa_field_ring(q, pts, vecs, lam, mesh4), 10))
        t_1.append(time_ms(lambda: yk.yukawa_field_cuda(q, pts, vecs, lam), 10))
        t_1.append(time_ms(lambda: yk.yukawa_field_cuda(q, pts, vecs, lam), 10))
        t_r.append(time_ms(lambda: yukawa_field_ring(q, pts, vecs, lam, mesh4), 10))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain_ring(yk, q, pts, vecs, lam, 4)
    torch.cuda.synchronize()
    ring_plain_ms = (time.perf_counter() - t0) * 1e3
    ring_ms = statistics.median(t_r)
    bound = pair_bound_ms(Q * S, Q, S, sfu)
    print(f"  ring at the barycenters Q={Q} S={S} on 4 shards: {ring_launches['partial']} partial "
          f"+ {ring_launches['merge']} merge launches in the 1-D and 2-D rings; max err vs K1 in "
          f"one launch {err_one:.3e}, vs the plain ring {err_plain:.3e} (tol {DIR_TOL:g}); 1-D and "
          f"2 x 2 bitwise equal {torch.equal(ring4, ring22)}; the mesh solve's Y is the ring's "
          f"{torch.equal(torch.as_tensor(res4.Y, dtype=torch.float32, device=dev), ring4)}; "
          f"{ring_ms:.3f} ms (turns {[round(t, 3) for t in t_r]}) against one launch "
          f"{statistics.median(t_1):.3f} ms (turns {[round(t, 3) for t in t_1]}), plain "
          f"{ring_plain_ms:.1f} ms, SFU bound {bound:.3f} ms ({100 * bound / ring_ms:.1f}%; {smi})")
    check(ring_launches == dict(partial=32, merge=8), "the rings launched 16 partial + 4 merge each")
    check(max(err_one, err_plain) <= DIR_TOL, "the ring at the barycenters within 1e-4 of K1")
    check(torch.equal(ring4, ring22), "the 1-D and 2 x 2 rings give one field bit for bit")
    check(torch.equal(torch.as_tensor(res4.Y, dtype=torch.float32, device=dev), ring4),
          "the mesh solve's Step-1 field is the ring's")
    del ring4, ring22, one_launch, plain

    # --- launches of one warm mesh solve against one device's
    with no_plain_yukawa(yk), no_plain_sell(pell), eager_allowed():
        prof = profile_solve("warm CR solve on 4 shards", lambda: s4.compute_distance(geom, opts),
                             statistics.median(warm), smi)
    print(f"  a warm mesh solve: {prof['launches']} launches, {prof['kernel_ms']:.1f} ms of kernel "
          f"time (one device's eager solve: phase 22) ({smi})")
    tet_ring = dict(launches=launches["partial"] + launches["merge"], max_abs_err=err_plain,
                    ms=ring_ms, plain_ms=ring_plain_ms, bound_ms=bound)
    tet_mesh = {k: k2_l[k] + k2_h[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms")}
    tet_mesh.update(launches=launches["k2"], max_abs_err=max(k2_l["max_abs_err"],
                                                             k2_h["max_abs_err"]))
    return tet_ring, tet_mesh


def analytic_rel(res) -> float:
    """rel-L2 of a grid solve's phi against the unit sphere's |x| - 1."""
    from shm3d_torch.ops.farfield import _positions_of

    g = res.grid
    pos = _positions_of(np.arange(g.n ** 3, dtype=np.int64), g).astype(np.float64)
    exact = np.linalg.norm(pos, axis=1) - 1.0
    return float(np.linalg.norm(res.phi - exact) / np.linalg.norm(exact))


def print_grid_solves(what, runs):
    for k, r in enumerate(runs):
        st = r["stats"]
        print(f"  {what} solve {k} ({'cold' if k == 0 else 'warm'}): {r['s']:.4f} s, tier "
              f"{st['tier']}, yukawa launches {r['k1']}, iters {st.get('iters')}, rel_res "
              f"{st.get('rel_res')}, refine_pass_rels {st.get('refine_pass_rels')}, "
              f"correction_iters {st.get('correction_iters')}, Gram LU solves "
              f"{span_s(st, 'Gram lu.solve')}, host_loop {st.get('host_loop')}, correction_host_loop "
              f"{st.get('correction_host_loop')}, mem_peak_mb {st.get('mem_peak_mb', 0):.1f}, "
              f"phases {json.dumps(st['phases'])}")


def grid256_phase(smi, dev, sfu, geom, analytic_128):
    """The main path at 256^3: the subsampled fast tier, the default tier
    and a refined reference; returns the Yukawa kernel's numbers at the
    256^3 launch shapes with this phase's launches.  ``geom``: the main
    path's cloud, whose source quadrature (~30 s on the host) it computed."""
    from shm3d_torch import SignedHeatOptions, SignedHeatSolver
    from shm3d_torch.ops import yukawa as yk
    from shm3d_torch.ops.farfield import DeviceShellPlan
    from shm3d_torch.solve import pell

    opts = SignedHeatOptions(dtype="float32", h_coef=H_COEF_256, refine_steps=0,
                             solver_maxiter=2000, step1_method="auto", disk_cache=False)
    solver = SignedHeatSolver("grid", device=dev)
    GRAPH_PATHS["sphere52k-256 fast tier"] = (solver, geom, opts, TURNS)
    # the default tier's warm solves take 7-9 s each: phase 22 takes one
    # eager and one graphed turn and profiles the graphed solve only
    GRAPH_PATHS["sphere52k-256 default tier"] = (solver, geom, opts.with_(refine_steps=1),
                                                 ("eager", "graph"))
    yk.KERNEL_LAUNCHES = 0
    fast, res_fast = timed_solves(solver, geom, opts, 4, yk, pell)
    # the default tier's warm solves take 8-9 s each: one cold and one warm
    # (three warm before phase 19 needed the room)
    default, res_def = timed_solves(solver, geom, opts.with_(refine_steps=1), 2, yk, pell)
    (ref,), res_ref = timed_solves(
        solver, geom, opts.with_(refine_steps=8, refine_target=1e-11), 1, yk, pell)
    launches = yk.KERNEL_LAUNCHES
    cached = next(iter(solver._impl._cache.values()))
    m, m_pin = int(cached["nodes8"].shape[0]), int(cached["pin_nodes8"].shape[0])
    phi_ref = res_ref.phi
    nrm = float(np.linalg.norm(phi_ref))
    rel_fast = float(np.linalg.norm(res_fast.phi - phi_ref)) / nrm
    rel_def = float(np.linalg.norm(res_def.phi - phi_ref)) / nrm
    analytic = analytic_rel(res_def)
    print(f"grid 256^3: sphere cloud S={N_POINTS}, h_coef={H_COEF_256}, grid {res_fast.grid.n}^3, "
          f"float32, m={m} constraint rows, {m_pin} pinned on the device")
    print_grid_solves("fast-tier", fast)
    print_grid_solves("default-tier", default)
    print_grid_solves("reference (refine_steps=8, refine_target=1e-11)", [ref])
    for name, runs in (("fast", fast), ("default", default)):
        warm = [r["s"] for r in runs[1:]]
        print(f"  warm {name}-tier solves {[round(w, 4) for w in warm]} s, median "
              f"{statistics.median(warm):.4f} s; distinct phi {len({r['phi'] for r in runs})} ({smi})")
    print(f"  rel-L2 against the reference: fast tier {rel_fast:.6e} (limit "
          f"{SUBSAMPLED_REL_L2_MAX:g}; shm3d 9.5e-4 with 4,096 pins), default tier "
          f"{rel_def:.6e} (limit {FAST_TIER_REL_L2_MAX:g}); rel-L2 vs |x|-1 of the default "
          f"tier {analytic:.6e}, {analytic / analytic_128:.3f}x 128^3's {analytic_128:.6e}; "
          f"yukawa launches {launches}")
    check(all(r["stats"]["tier"] == "subsampled" for r in fast + default + [ref]),
          "256^3 takes the subsampled-pin tier")
    check(m == ROWS_256 and m_pin == PINS_256,
          f"256^3 rows {m} and pins {m_pin} are the host code's {ROWS_256} and {PINS_256}")
    for name, runs in (("fast", fast), ("default", default)):
        check(len({r["phi"] for r in runs}) == 1, f"the 256^3 {name}-tier solves give one phi")
        check(all(r["k1"] == 2 for r in runs), f"every 256^3 {name}-tier solve launched K1 twice")
    check(bool(np.isfinite(res_def.phi).all()) and res_def.phi.shape == (res_def.grid.n ** 3,),
          "256^3 phi finite, one value a node")
    check(rel_def <= FAST_TIER_REL_L2_MAX, "256^3 default tier within 1e-5 of its reference")
    check(rel_fast <= SUBSAMPLED_REL_L2_MAX, "256^3 subsampled fast tier within 1e-2")
    lo, hi = ANALYTIC_RATIO_256
    check(lo <= analytic / analytic_128 <= hi, "256^3 analytic rel-L2 0.4-0.6x 128^3's")
    # the default tier's time is in the correction's spans
    profile_solve("warm 256^3 fast-tier solve", lambda: solver.compute_distance(geom, opts),
                  statistics.median([r["s"] for r in fast[1:]]), smi, names=GRID_KERNELS,
                  eager=True)

    # K1 at the 256^3 launch shapes
    plan = next(v for v in cached.values() if isinstance(v, DeviceShellPlan))
    pts, vecs = cached["points"], cached["vectors"]
    lam = float(np.sqrt(1.0 / (opts.t_coef * cached["spacing"] ** 2)))
    rows = np.sort(np.random.default_rng(6).choice(plan.shell_pos.shape[0], size=SAMPLE_ROWS,
                                                   replace=False))
    sample = plan.shell_pos[torch.as_tensor(rows, device=dev)].contiguous()
    err_s, _ = compare(yk, sample, pts, vecs, lam, True)
    err_c, got_c = compare(yk, plan.coarse_pos, pts, vecs, lam, True)
    unit_c = (torch.linalg.vector_norm(got_c, dim=1) - 1).abs().max().item()
    print(f"kernel vs plain  256^3 shell sample Q={sample.shape[0]} S={pts.shape[0]}: max err "
          f"{err_s:.3e}; coarse launch Q={plan.coarse_pos.shape[0]}: max err {err_c:.3e}, "
          f"| |Y|-1 | <= {unit_c:.1e} (tol {DIR_TOL:g}); launches split into "
          f"{chunks(yk, plan.shell_pos, pts)} (shell) and {chunks(yk, plan.coarse_pos, pts)} (coarse)")
    check(max(err_s, err_c) <= DIR_TOL and unit_c <= 1e-5, "K1 at the 256^3 shapes within tolerance")
    times, bound = {}, 0.0
    for name, fn, reps in (("kernel", yk.yukawa_field_cuda, 3), ("plain", yk.yukawa_field_torch, 1)):
        t = [time_ms(lambda: fn(q, pts, vecs, lam), reps) for q in (plan.shell_pos, plan.coarse_pos)]
        times[name] = sum(t)
        print(f"  {name}: shell Q={plan.shell_pos.shape[0]} {t[0]:.3f} ms, coarse "
              f"Q={plan.coarse_pos.shape[0]} {t[1]:.3f} ms ({smi})")
    S = int(pts.shape[0])
    for q in (plan.shell_pos, plan.coarse_pos):
        bound += pair_bound_ms(int(q.shape[0]) * S, int(q.shape[0]), S, sfu)
    print(f"  yukawa kernel at 256^3: {times['kernel']:.3f} ms a solve against its SFU bound "
          f"{bound:.3f} ms ({100 * bound / times['kernel']:.1f}% of the bound); plain "
          f"{times['plain']:.1f} ms ({smi})")
    return dict(launches=launches, max_abs_err=max(err_s, err_c), ms=times["kernel"],
                plain_ms=times["plain"], bound_ms=bound)


def hostproj_phase(smi, dev, geom, phi_ref_128):
    """The host-projected tier at 128^3 (max_device_pins=None) on the main
    path's cloud, its source quadrature computed; returns its Yukawa
    launches (the main path's shapes)."""
    from shm3d_torch import SignedHeatOptions, SignedHeatSolver
    from shm3d_torch.ops import yukawa as yk
    from shm3d_torch.solve import pell, projection

    opts = SignedHeatOptions(dtype="float32", h_coef=H_COEF, refine_steps=0,
                             solver_maxiter=2000, step1_method="auto", disk_cache=False,
                             max_device_pins=None)
    solver = SignedHeatSolver("grid", device=dev)
    GRAPH_PATHS["sphere52k-128 host-projected"] = (solver, geom, opts, TURNS)
    yk.KERNEL_LAUNCHES = 0
    runs, res = timed_solves(solver, geom, opts, 3, yk, pell)
    launches = yk.KERNEL_LAUNCHES
    m = int(next(iter(solver._impl._cache.values()))["nodes8"].shape[0])
    rel = float(np.linalg.norm(res.phi - phi_ref_128) / np.linalg.norm(phi_ref_128))
    print(f"host-projected tier: the main path's input with max_device_pins=None, m={m}")
    print_grid_solves("host-projected", runs)
    for r in runs[1:]:
        st, it = r["stats"], r["stats"]["iters"]
        # the primary solve's loop: its Gram solves, not the corrections'
        grams, gram_s = span_s(st, "Gram lu.solve", under="host-projected cg solve")
        loop = next(x for x in st["spans"] if x[0] == "host-projected cg solve")
        loop_s = (loop[4] - loop[3]) / 1e9
        print(f"  warm: {r['s']:.4f} s, {it} iterations, {grams} host Gram solves "
              f"{gram_s:.4f} s of the loop's {loop_s:.4f} s "
              f"({gram_s / loop_s:.1%}); {1e3 * loop_s / max(it, 1):.2f} ms "
              f"an iteration, {1e3 * gram_s / max(grams, 1):.2f} ms a Gram "
              f"solve ({smi})")
    print(f"  rel-L2 against the 128^3 reference {rel:.6e} (limit {FAST_TIER_REL_L2_MAX:g}); "
          f"distinct phi {len({r['phi'] for r in runs})}")
    check(all(r["stats"]["tier"] == "host-projected" for r in runs)
          and m > projection.ORTHO_GRAM_CAP,
          "max_device_pins=None at 128^3 takes the host-projected tier")
    check(len({r["phi"] for r in runs}) == 1, "the host-projected solves give one phi")
    check(rel <= FAST_TIER_REL_L2_MAX, "host-projected fast tier within 1e-5 of the reference")
    check(all(r["k1"] == 2 for r in runs), "every host-projected solve launched K1 twice")
    stencil_path("sphere52k-128 host-projected", [r["stats"] for r in runs], res.grid.n,
                 "hostproj", False)
    profile_solve("warm host-projected solve", lambda: solver.compute_distance(geom, opts),
                  statistics.median([r["s"] for r in runs[1:]]), smi, names=GRID_KERNELS)
    return launches


def wavefront_phase(smi, dev, solver, geom, opts):
    """Fast integration at 128^3 on the main path's solver (a cache hit);
    returns its Yukawa launches (the main path's shapes)."""
    from shm3d_torch.ops import yukawa as yk
    from shm3d_torch.ops.farfield import _positions_of
    from shm3d_torch.ops.wavefront import greedy_integrate_wavefront
    from shm3d_torch.solve import pell

    GRAPH_PATHS["sphere52k-128 wavefront"] = (solver, geom, opts.with_(fast_integration=True),
                                              TURNS)
    yk.KERNEL_LAUNCHES = 0
    runs, res = timed_solves(solver, geom, opts.with_(fast_integration=True), 2, yk, pell)
    launches = yk.KERNEL_LAUNCHES
    st = runs[-1]["stats"]
    g = res.grid
    print(f"fast integration at {g.n}^3: step 3 {st['step3_path']}, {st['wavefront_sweeps']} "
          f"sweeps, {st['wavefront_visited']} of {g.n ** 3} nodes visited; solves "
          f"{[round(r['s'], 4) for r in runs]} s, step-3 phase "
          f"{st['phases'].get('step 3 (greedy wavefront integration, device)', 0):.4f} s, "
          f"distinct phi {len({r['phi'] for r in runs})} ({smi})")
    check(all(r["stats"]["step3_path"] == "greedy-wavefront" for r in runs),
          "fast integration at 128^3 takes the device wavefront")
    check(st["wavefront_visited"] == g.n ** 3, "the wavefront visited every node")
    check(len({r["phi"] for r in runs}) == 1 and bool(np.isfinite(res.phi).all()),
          "two wavefront solves give one finite phi")
    check(all(r["k1"] == 2 for r in runs), "every wavefront solve launched K1 twice")
    stencil_path("sphere52k-128 wavefront", [r["stats"] for r in runs], g.n, "wavefront", False)
    profile_solve("wavefront solve", lambda: solver.compute_distance(
        geom, opts.with_(fast_integration=True)), runs[-1]["s"], smi, names=GRID_KERNELS)
    # a constant unit field integrates to the exact linear phi
    d = np.array([1.0, 2.0, -0.5])
    d /= np.linalg.norm(d)
    Y = torch.as_tensor(np.tile(d, (g.n ** 3, 1)), dtype=torch.float32, device=dev)
    chunk_graphs = {}
    for _ in range(2):  # the first call captures its chunk graphs
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        phi, sweeps, _ = greedy_integrate_wavefront(Y, float(g.cell_size), g.shape,
                                                    cache=chunk_graphs)
        torch.cuda.synchronize()
        t = time.perf_counter() - t0
    pos = _positions_of(np.arange(g.n ** 3, dtype=np.int64), g).astype(np.float64)
    exact = (pos - pos[0]) @ d
    rel = float(np.linalg.norm(phi.cpu().numpy() - exact) / np.linalg.norm(exact))
    print(f"  constant field: {sweeps} sweeps in {t:.4f} s (the second call; the first "
          f"captured its chunk graphs), rel-L2 against the exact linear "
          f"phi {rel:.3e} (limit 1e-5; {smi})")
    check(rel <= 1e-5, "the wavefront is exact on a constant field")
    return launches


def cli_phase(smi):
    """The CLI on the card: bunny_dec on a 64^3 grid, phi written."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        phi_path = os.path.join(tmp, "phi.npy")
        cmd = [sys.executable, "-m", "shm3d_torch.cli", BUNNY, "--grid", "--h", "2",
               "--device", "cuda", "--no-disk-cache", "--export-phi", phi_path, "--json"]
        t0 = time.perf_counter()
        out = subprocess.run(cmd, capture_output=True, text=True, cwd=REPO, timeout=600,
                             env=dict(os.environ, PYTHONPATH=REPO))
        s = time.perf_counter() - t0
        check(out.returncode == 0, f"the CLI exits 0 ({out.stderr[-1500:]})")
        summary = json.loads(out.stdout.strip().splitlines()[-1])
        phi = np.load(phi_path)
    print(f"cli: {' '.join(cmd[1:])}: {s:.2f} s, summary {json.dumps(summary)} ({smi})")
    check(summary["device"] == "cuda" and phi.shape == (64 ** 3,)
          and bool(np.isfinite(phi).all()), "the CLI wrote a finite 64^3 phi on the card")


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
        check(torch.equal(got, ys.skeleton_sum(q, pts, lam)),
              f"two skeleton launches on the {name} agree bit for bit")
    # a ragged case and a case that spans several source chunks
    for name, nq, ns in (("ragged", 5003, 4099), ("several chunks", 36001, 52290)):
        q = torch.as_tensor(rng.standard_normal((nq, 3)), dtype=torch.float32, device=dev)
        p = torch.as_tensor(rng.standard_normal((ns, 3)) * 0.3, dtype=torch.float32, device=dev)
        got = ys.skeleton_sum_cuda(q, p, ROOFLINE_LAM)
        again = ys.skeleton_sum_cuda(q, p, ROOFLINE_LAM)
        ref = ys.skeleton_sum_torch(q, p, ROOFLINE_LAM)
        n_chunks = -(-ns // ys.skeleton_chunk_len(nq, ns, dev))
        rel = row_rel_err(got, ref)
        errs.append((got - ref).abs().max().item())
        print(f"skeleton kernel vs plain  {name} Q={nq} S={ns}: {n_chunks} source chunks, "
              f"max err / row sum {rel:.3e} (tol {SKELETON_RTOL:g}), two launches bitwise "
              f"equal {torch.equal(got, again)}")
        check(rel <= SKELETON_RTOL, f"skeleton kernel {name} case within tolerance")
        check(torch.equal(got, again), f"skeleton kernel {name} case repeats bit for bit")
        check(n_chunks > 1 or name == "ragged", "the several-chunks case splits its sources")

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
                   k1_chunks=chunks(yk, q, p),
                   k3_chunks=-(-S // ys.skeleton_chunk_len(Q, S, dev)))
        rows_out.append(row)
        print(f"  {label} Q={Q} S={S}: yukawa {k1_ms:.3f} ms ({row['k1_pairs_s']:.3e} pairs/s, "
              f"{row['k1_pct_sfu']:.1f}% of SFU), skeleton {k3_ms:.3f} ms "
              f"({row['k3_pairs_s']:.3e} pairs/s, {row['k3_pct_sfu']:.1f}% of SFU, "
              f"{row['k3_chunks']} source chunks); "
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


def grid_k1_check(yk, plan, pts, vecs, lam, dev, smi, what):
    """K1 against its plain version at a 128^3 grid path's two launch shapes
    (a sample of the shell launch, the whole coarse launch), each timed on
    both routes; returns (max error, {"kernel": ms, "plain": ms})."""
    rows = np.sort(np.random.default_rng(1).choice(
        plan.shell_pos.shape[0], size=min(SAMPLE_ROWS, plan.shell_pos.shape[0]),
        replace=False))
    sample = plan.shell_pos[torch.as_tensor(rows, device=dev)].contiguous()
    err, _ = compare(yk, sample, pts, vecs, lam, True)
    print(f"kernel vs plain  {what} shell sample Q={sample.shape[0]} "
          f"S={pts.shape[0]}: max err {err:.3e} (tol {DIR_TOL:g})")
    check(err <= DIR_TOL, f"{what} shell sample within tolerance")
    # the whole coarse launch: its far rows underflow in an unscaled float32
    # sum (12,099 of them in the speed-of-light probe); here every row must
    # be finite and of unit norm
    err_c, got_c = compare(yk, plan.coarse_pos, pts, vecs, lam, True)
    unit_c = (torch.linalg.vector_norm(got_c, dim=1) - 1).abs().max().item()
    print(f"kernel vs plain  {what} coarse launch Q={plan.coarse_pos.shape[0]} "
          f"S={pts.shape[0]}: max err {err_c:.3e} (tol {DIR_TOL:g}), | |Y|-1 | <= "
          f"{unit_c:.1e}; launches split into {chunks(yk, plan.coarse_pos, pts)} "
          f"(coarse) and {chunks(yk, plan.shell_pos, pts)} (shell)")
    check(bool(torch.isfinite(got_c).all()) and unit_c <= 1e-5,
          "every coarse row finite and of unit norm")
    check(err_c <= DIR_TOL, f"{what} coarse launch within tolerance")
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
    return err, times


def minres_phase(smi, dev, solver, geom, opts, main):
    """Phase 19, the grid's MINRES-on-KKT Step 3 (``solver_method=
    "minres_kkt"``), every solve with K1's plain versions stubbed to fail:
    20 iterations at 128^3 timed first; (a) the icosphere at 16^3, Step 3 in
    float64 on the card given the float32 solve's Y, against
    projected CG and on four shards of the card; (b) and (d) one solve of
    the main path's input at the default ``solver_maxiter`` and
    ``refine_steps=1``: (b) reads its MINRES solution as it enters the
    defect correction (what a ``refine_steps=0`` solve returns), (d) the
    default tier's phi; (c) at ``solver_maxiter=200``, two one-device solves
    and one on four shards of the card.  Returns K1's launches in (b)'s
    solve, the path's own.  ``main``: the main path's phi, Y and rel-L2
    against |x| - 1, and phase 8's reference."""
    from shm3d_torch import SignedHeatOptions, make_icosphere
    from shm3d_torch.ops import yukawa as yk
    from shm3d_torch.parallel import device_mesh
    from shm3d_torch.parallel.shards import shard_rows
    from shm3d_torch.solvers import grid as tgrid
    from shm3d_torch.utils.timing import PhaseTimer

    step3 = "step 3 (divergence + KKT MINRES solve)"
    kkt = opts.with_(solver_method="minres_kkt",
                     solver_maxiter=SignedHeatOptions().solver_maxiter)
    impl = solver._impl
    k1 = []  # K1's launches in each solve of the phase, for the log

    def one(s, o, g=geom):
        yk.KERNEL_LAUNCHES = 0
        t0 = time.perf_counter()
        with no_plain_yukawa(yk):
            res = s.compute_distance(g, o)
            torch.cuda.synchronize()
        k1.append(yk.KERNEL_LAUNCHES)
        return res, time.perf_counter() - t0, dict(s.last_stats)

    one(solver, kkt.with_(solver_maxiter=20))  # the first MINRES call sets up
    res, s20, st = one(solver, kkt.with_(solver_maxiter=20))
    per_iter = st["phases"][step3] / st["iters"]
    print(f"minres_kkt: 20 iterations at {res.grid.n}^3: {s20:.3f} s a solve, Step 3 "
          f"{st['phases'][step3]:.3f} s, {1e3 * per_iter:.2f} ms an iteration; "
          f"{kkt.solver_maxiter} iterations would take {kkt.solver_maxiter * per_iter:.1f} s ({smi})")
    check(st["iters"] == 20 and st["step3_path"] == "minres-kkt", "20 MINRES iterations")
    stencil_path("sphere52k-128 minres_kkt, 20 iterations", [st], res.grid.n, "krylov", False)

    # --- (a) the icosphere at 16^3: Step 3 in float64 on the card, on one
    # device and on four shards of it
    ico = make_icosphere(2)
    o32 = SignedHeatOptions(dtype="float32", refine_steps=0, disk_cache=False)
    o64 = o32.with_(dtype="float64", solver_tol=1e-10)
    s16 = tgrid.GridSolver(device=dev)
    Y = one(s16, o32, ico)[0].Y.to(torch.float64)
    c64 = tgrid.cached_from_arrays(s16._build_host_arrays(ico, o64), dev, torch.float64)
    g16 = c64["grid"]
    u16, phi16, iters16 = {}, {}, {}
    for method in ("minres_kkt", "projected_cg"):
        u16[method] = s16._integrate_exact(Y, c64, g16, True, 1e-10,
                                           o64.with_(solver_method=method), PhaseTimer(dev))
        phi16[method] = tgrid._mean_shift(-u16[method], c64["src_nodes8"], c64["src_coeffs8"],
                                          c64["weights"]).cpu().numpy()
        iters16[method] = s16.last_stats["iters"]
    rel16 = float(np.linalg.norm(phi16["minres_kkt"] - phi16["projected_cg"])
                  / np.linalg.norm(phi16["projected_cg"]))
    mesh16 = device_mesh(devices=[dev] * 4)
    sm16 = tgrid.GridSolver(mesh=mesh16)
    um = sm16._integrate_exact(shard_rows(Y, mesh16), sm16._slab_tables(c64, g16), g16, True,
                               1e-10, o64.with_(solver_method="minres_kkt"),
                               PhaseTimer(dev)).gather()
    u1 = u16["minres_kkt"]
    rel16_mesh = float(torch.linalg.vector_norm(um - u1) / torch.linalg.vector_norm(u1))
    iters16_mesh = sm16.last_stats["iters"]
    print(f"  (a) icosphere 16^3, float64 Step 3 on the card given K1's Y: minres_kkt "
          f"{iters16['minres_kkt']} iterations, projected_cg {iters16['projected_cg']}; "
          f"phi rel-L2 between them {rel16:.3e} (limit 1e-7, the JAX package's bar); "
          f"minres_kkt on 4 shards {iters16_mesh} iterations, u rel-L2 vs one device "
          f"{rel16_mesh:.3e} (limits 2 iterations and 1e-9, as on the CPU's shards); "
          f"K1 launches {k1[-1]}")
    check(rel16 <= 1e-7, "minres_kkt within 1e-7 of projected_cg at 16^3 in float64")
    check(sm16.last_stats["step3_path"] == "minres-kkt"
          and abs(iters16_mesh - iters16["minres_kkt"]) <= 2 and rel16_mesh <= 1e-9,
          "the float64 MINRES on 4 shards of the card within 1e-9 of one device's")

    # --- (b) and (d): the main path's input at full width, default
    # solver_maxiter, one solve through the defect correction.  (b) reads
    # MINRES's u as it enters the correction: the u (and the phi) of a
    # refine_steps=0 solve, which takes the same Step 3 from the same Y
    entering = []
    refine = impl._refine_or_skip

    def spy(u, *args):
        entering.append(u.clone())
        return refine(u, *args)

    impl._refine_or_skip = spy
    try:
        res_d, s_d, st_d = one(solver, kkt.with_(refine_steps=1))
    finally:
        del impl._refine_or_skip
    launches = k1[-1]
    cached = next(iter(impl._cache.values()))
    u_b = entering[0]
    res_b = tgrid.GridResult(tgrid._mean_shift(-u_b, cached["src_nodes8"], cached["src_coeffs8"],
                                               cached["weights"]), res_d.grid, res_d.Y, u_dev=u_b)
    rel_fast = float(np.linalg.norm(res_b.phi - main["phi"]) / np.linalg.norm(main["phi"]))
    analytic = analytic_rel(res_b)
    print(f"  (b) main path's input, minres_kkt, solver_maxiter {kkt.solver_maxiter}: "
          f"{st_d['iters']} iterations, final phibar {st_d['rel_res']:.4e}, Step 3 "
          f"{st_d['phases'][step3]:.3f} s, K1 launches {launches}; rel-L2 vs the "
          f"fast tier {rel_fast:.4e} (limit {MINRES_REL_L2_FAST_MAX:g}), vs |x|-1 "
          f"{analytic:.6e} (fast tier {main['analytic']:.6e}; band "
          f"{MINRES_ANALYTIC_BAND:.0%}) ({smi})")
    check(st_d["step3_path"] == "minres-kkt" and launches == 2 and len(entering) == 1,
          "the MINRES solve took its path with K1 twice")
    stencil_path("sphere52k-128 minres_kkt, default tier", [st_d], res_d.grid.n, "krylov", False)
    check((st_d["iters"], f"{st_d['rel_res']:.4e}") == EAGER_MINRES,
          f"MINRES repeats the eager loops' {EAGER_MINRES[0]} iterations to phibar {EAGER_MINRES[1]}")
    check(bool(np.isfinite(res_b.phi).all()), "MINRES phi finite")
    check(torch.equal(res_d.Y, main["Y"]), "the MINRES solve's Step-1 field is the main path's")
    check(rel_fast <= MINRES_REL_L2_FAST_MAX, "MINRES phi near the fast tier's")
    check(abs(analytic - main["analytic"]) <= MINRES_ANALYTIC_BAND * main["analytic"],
          "MINRES phi's distance from |x|-1 near the fast tier's")
    rel_d = float(np.linalg.norm(res_d.phi - main["phi_ref"]) / np.linalg.norm(main["phi_ref"]))
    print(f"  (d) default tier after MINRES, the same solve: {s_d:.3f} s, defect correction "
          f"{st_d['phases'].get('float64 defect correction', 0):.3f} s, refine_pass_rels "
          f"{st_d.get('refine_pass_rels')}, refine_rel_res {st_d.get('refine_rel_res')}, "
          f"correction_iters {st_d.get('correction_iters')}; rel-L2 vs phase 8's reference "
          f"{rel_d:.4e}; mem_peak_mb {st_d.get('mem_peak_mb', 0):.1f} ({smi})")
    check("refine_skipped" not in st_d and st_d["refine_rel_res"] <= st_d["refine_pass_rels"][0],
          "the default tier after MINRES corrected the defect")
    check(rel_d <= MINRES_DEFAULT_REL_L2_MAX, "the default tier after MINRES near the reference")

    # --- (c) 200 iterations: one phi twice, and four shards of the card
    o200 = kkt.with_(solver_maxiter=200)
    GRAPH_PATHS["sphere52k-128 MINRES, 200 iterations"] = (solver, geom, o200, TURNS)
    STOP_PATHS["sphere52k-128 MINRES float32, 200 iterations"] = (solver, geom, o200)
    (ra, _, sta), (rb, _, _) = one(solver, o200), one(solver, o200)
    with no_plain_yukawa(yk):
        profile_solve("20-iteration MINRES solve",
                      lambda: solver.compute_distance(geom, kkt.with_(solver_maxiter=20)),
                      s20, smi, names=GRID_KERNELS, eager=True)
    mesh_solver = tgrid.GridSolver(mesh=device_mesh(devices=[dev] * 4))
    mesh_solver._cache.update(impl._cache)  # the one device's discretization
    rm, s_m, stm = one(mesh_solver, o200)
    u1 = ra.u_device
    rel_mesh = float(torch.linalg.vector_norm(rm.u_device - u1) / torch.linalg.vector_norm(u1))
    sens = []
    for seed in (0, 1):  # Y changed by a rounding-size relative amount
        z = torch.as_tensor(np.random.default_rng(seed).standard_normal(tuple(ra.Y.shape)),
                            dtype=ra.Y.dtype, device=dev)
        up = impl._integrate_exact(ra.Y * (1 + 2.0 ** -23 * z), cached, cached["grid"], False,
                                   o200.resolved_solver_tol(), o200, PhaseTimer(dev))
        sens.append(float(torch.linalg.vector_norm(up - u1) / torch.linalg.vector_norm(u1)))
    print(f"  (c) solver_maxiter=200: one device {sta['iters']} iterations, phibar "
          f"{sta['rel_res']:.4e}, two solves bitwise equal {np.array_equal(ra.phi, rb.phi)}; "
          f"4 shards {stm['iters']} iterations, phibar {stm['rel_res']:.4e}, {s_m:.3f} s "
          f"(Step 3 {stm['phases'][step3]:.3f} s against one device's "
          f"{sta['phases'][step3]:.3f} s), K1 launches {k1[-1]}, u rel-L2 vs one device "
          f"{rel_mesh:.4e}; one device with Y perturbed by 2^-23 relative: "
          f"{', '.join(f'{x:.4e}' for x in sens)} (limit {MINRES_MESH_SENSITIVITY:g}x the "
          f"larger) ({smi})")
    check(np.array_equal(ra.phi, rb.phi), "two MINRES solves give one phi")
    check(sta["iters"] == stm["iters"] == 200, "the mesh's MINRES takes one device's iterations")
    check(stm["mesh"]["step3"] == "z-slabs" and torch.equal(rm.Y, ra.Y),
          "the mesh solve ran on z-slabs from one device's Y")
    check(k1[-1] == 8, "K1 twice on each of 4 shards")
    check(rel_mesh <= MINRES_MESH_SENSITIVITY * max(sens),
          "the mesh moves MINRES no further than rounding of Y does")
    print(f"  K1 launches a solve in phase 19: {k1}; the path's own, (b)'s: {launches}")
    return launches


def f64_ptxas_lines():
    """The -Xptxas -v lines of K1's float64 instantiations (the
    ``...IdEE...`` entry functions): registers, shared memory, spills."""
    from shm3d_torch import _build

    lines = _build.BUILD_INFO["log"].splitlines()
    out = []
    for k, line in enumerate(lines):
        if "Compiling entry function" in line and "yukawa_" in line and "IdEE" in line:
            name = "partial" if "partial_kernel" in line else "merge"
            out += [f"float64 {name} kernel: {x.strip()}" for x in lines[k + 1:k + 4]
                    if "Used" in x or "spill" in x]
    return out


def _sass_op(text):
    """The opcode of one SASS instruction, its predicate stripped."""
    words = text.split()
    return words[1] if words[0].startswith("@") else words[0]


def sass_fp64_per_pair():
    """FP64 instructions a pair in the float64 partial kernel, read from the
    built library's SASS (``cuobjdump -sass``): in the innermost loop that
    evaluates pairs (a backward branch whose range holds no other loop and
    the most MUFU.RSQ64H, one a pair), the FP64-pipe instructions (DADD,
    DMUL, DFMA, DSETP, DSET, DMNMX and the *.F64 conversions) over its
    MUFU.RSQ64H.  Returns (per pair, {opcode: count} a pair, pairs in the
    loop body), or None where the toolkit has no cuobjdump."""
    import re
    import shutil

    from shm3d_torch import _build

    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    tool = tool if os.path.isfile(tool) else shutil.which("cuobjdump")
    if not tool:
        return None
    sass = subprocess.run([tool, "-sass", str(_build.library_path())], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    body = next(f for f in sass.split("Function : ")[1:]
                if "yukawa_partial_kernelIdE" in f.split("\n", 1)[0])
    ins = [(int(m.group(1), 16), _sass_op(m.group(2)), m.group(2))
           for m in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+([^;]+);", body)]
    loops = []
    for at, op, text in ins:
        target = re.search(r"0x([0-9a-f]+)", text)
        if op.startswith("BRA") and target and int(target.group(1), 16) < at:
            loops.append((int(target.group(1), 16), at))
    inner = [(a, b) for a, b in loops
             if not any(a <= c and d <= b and (c, d) != (a, b) for c, d in loops)]
    fp64 = ("DADD", "DMUL", "DFMA", "DSETP", "DSET", "DMNMX")

    def counts(a, b):
        c = {}
        for at, op, _ in ins:
            if a <= at <= b and (op.split(".")[0] in fp64 or op.startswith("MUFU.RSQ64H")
                                 or (".F64" in op and not op.startswith("MUFU"))):
                c[op] = c.get(op, 0) + 1
        return c

    best = max(inner, key=lambda ab: counts(*ab).get("MUFU.RSQ64H", 0))
    c = counts(*best)
    pairs = c.pop("MUFU.RSQ64H", 0)
    if pairs == 0:
        return None
    return sum(c.values()) / pairs, {k: v / pairs for k, v in sorted(c.items())}, pairs


def row_rel(got, ref) -> float:
    """max over rows of max |got - ref| / max |ref| in the row; a row equal
    to its reference counts 0 (an unnormalized sum far from every source
    underflows to 0 even in float64), any other row of a zero reference
    inf."""
    diff = (got - ref).abs().amax(dim=1)
    return torch.where(diff == 0, 0.0, diff / ref.abs().amax(dim=1)).max().item()


def f64_kernel_cases(yk, dev):
    """K1's float64 instantiation against its float64 plain version on
    seeded synthetic inputs (ragged, a query on a source, far queries with a
    large lambda, padded sources), fused and split (partials then merge,
    bitwise the fused call); returns the largest error per row."""
    rng = np.random.default_rng(20)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float64, device=dev)

    n = rng.normal(size=(3001, 3))
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    vn = n * rng.uniform(0.5, 1.5, (3001, 1))
    vr = rng.normal(size=(4099, 3)) * 0.3
    vr[:, 2] += 1.0
    pp, pv = yk.pad_sources(t(n), t(vn), 1024)
    cases = (("ragged Q=5003 S=4099", t(rng.uniform(-1, 1, (5003, 3))),
              t(rng.uniform(-1, 1, (4099, 3))), t(vr), 7.5),
             ("coincident Q=257 S=3001", t(n[:257]), t(n), t(vn), 10.0),
             ("far |q|=40 lam=50", t(40.0 * n[:1000] * [1, -1, 1]), t(n), t(vn), 50.0),
             (f"padded Q=777 S=3001+{pp.shape[0] - 3001}", t(rng.uniform(-1, 1, (777, 3))),
              pp, pv, 3.0))
    worst = 0.0
    for name, q, p, v, lam in cases:
        for normalize in (True, False):
            got = yk.yukawa_field_cuda(q, p, v, lam, normalize=normalize)
            chunk = yk.yukawa_chunk_len(q.shape[0], p.shape[0], dev, torch.float64)
            split = yk.yukawa_merge_cuda(yk.yukawa_partials_cuda(q, p, v, lam, chunk), normalize)
            ref = yk.yukawa_field_torch(q, p, v, lam, normalize=normalize)
            torch.cuda.synchronize()
            err = row_rel(got, ref)
            worst = max(worst, err)
            unit = ((torch.linalg.vector_norm(got, dim=1) - 1).abs().max().item()
                    if normalize else 0.0)
            print(f"float64 kernel vs plain  {name} normalize={normalize}: max err per row "
                  f"{err:.3e} (tol {F64_ROW_RTOL:g}), split = fused {torch.equal(split, got)}, "
                  f"| |Y|-1 | <= {unit:.1e} ({-(-p.shape[0] // chunk)} chunks of {chunk})")
            check(bool(torch.isfinite(got).all()) and unit <= 1e-14,
                  f"float64 {name}: finite, unit rows")
            check(err <= F64_ROW_RTOL and torch.equal(split, got),
                  f"float64 {name}: within tolerance, split bitwise the fused call")
    return worst


def f64_phase(smi, dev, geom, main):
    """Phase 20, float64 on the card, every solve on the card with K1's and
    K2's plain versions stubbed to fail: (a) K1's float64 instantiation on
    synthetic inputs and at the main path's two launches, timed against the
    float32 kernel in turns, with its registers, spills and FP64
    instructions a pair; (b) sphere52k-128 in float64; (c) the 16^3
    icosphere against the host oracle; (d) bunny_dec CR and vertex against
    the same solves on this machine's CPU, knot_dec CR; (e) the grid and
    bunny_dec CR on 1 x 4 and 2 x 2 meshes of the card; (f) the CLI.
    Returns the float64 K1 entry of the kernels line.  ``main``: the main
    path's float32 launch inputs (plan, points, vectors, lambda) and phase
    8's reference."""
    import tempfile

    from shm3d_torch import SignedHeatOptions, SignedHeatSolver, make_icosphere
    from shm3d_torch.io.mesh_io import read_geometry
    from shm3d_torch.ops import yukawa as yk
    from shm3d_torch.ops.farfield import DeviceShellPlan
    from shm3d_torch.oracle import reference as oracle
    from shm3d_torch.parallel import device_mesh
    from shm3d_torch.solve import pell
    from shm3d_torch.solvers import grid as tgrid

    t_phase = time.perf_counter()
    per_path = {}

    def counts():
        return (yk.KERNEL_LAUNCHES_F64, yk.PARTIAL_LAUNCHES_F64, yk.MERGE_LAUNCHES_F64,
                yk.KERNEL_LAUNCHES, yk.PARTIAL_LAUNCHES, yk.MERGE_LAUNCHES, pell.KERNEL_LAUNCHES)

    def on_card(solver, g, o, n=1):
        """n solves on the card with K1's and K2's plain versions stubbed:
        per solve its time, launches (float64 fused, partial, merge; float32
        any; K2), stats and phi hash; and the last result."""
        runs = []
        for _ in range(n):
            before = counts()
            t0 = time.perf_counter()
            with no_plain_yukawa(yk), no_plain_sell(pell):
                res = solver.compute_distance(g, o)
                torch.cuda.synchronize()
            d = [a - b for a, b in zip(counts(), before)]
            runs.append(dict(s=time.perf_counter() - t0, f64=tuple(d[:3]), f32=sum(d[3:6]),
                             k2=d[6], stats=dict(solver.last_stats),
                             phi=hashlib.sha1(res.phi.tobytes()).hexdigest()))
        return runs, res

    def rel(a, b):
        return float(np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(b))

    # --- (a) the kernel: build lines, synthetic cases
    for line in f64_ptxas_lines():
        print(f"  {line}")
    worst = f64_kernel_cases(yk, dev)

    # --- (b) sphere52k-128 in float64: 1 cold + 2 warm
    o64 = SignedHeatOptions(dtype="float64", h_coef=H_COEF, refine_steps=0, disk_cache=False)
    solver = SignedHeatSolver("grid", device=dev)
    GRAPH_PATHS["sphere52k-128-f64 host-projected"] = (solver, geom, o64, TURNS)
    runs, res = on_card(solver, geom, o64, 3)
    st = runs[-1]["stats"]
    analytic = analytic_rel(res)
    band = abs(analytic - JAX_ANALYTIC_REL_L2) / JAX_ANALYTIC_REL_L2
    rel_ref = rel(res.phi, main["phi_ref"])
    print(f"float64 on the card: sphere52k-128 ({N_POINTS} points, {res.grid.n}^3, "
          f"refine_steps=0, solver_tol {o64.resolved_solver_tol():g})")
    for k, r in enumerate(runs):
        rs = r["stats"]
        print(f"  solve {k} ({'cold' if k == 0 else 'warm'}): {r['s']:.4f} s, tier {rs['tier']}, "
              f"iters {rs['iters']}, rel_res {rs['rel_res']:.4e}, K1 float64 launches "
              f"{r['f64'][0]} (float32 {r['f32']}), K2 {r['k2']}, host_loop {rs.get('host_loop')}, "
              f"mem_peak_mb {rs['mem_peak_mb']:.1f}, phases {json.dumps(rs['phases'])} ({smi})")
    print(f"  rel-L2 vs |x|-1 {analytic:.6e} (JAX package, float32: {JAX_ANALYTIC_REL_L2:.6e}; "
          f"off by {band:.2%}, limit {ANALYTIC_BAND:.0%}); vs phase 8's refined reference "
          f"{rel_ref:.4e} (limit {FAST_TIER_REL_L2_MAX:g}); distinct phi "
          f"{len({r['phi'] for r in runs})}")
    check(all(r["stats"]["tier"] == "host-projected" for r in runs),
          "float64 at 128^3 takes the host-projected tier")
    check(all(r["stats"]["rel_res"] <= F64_RESIDUAL_MAX for r in runs), "float64 residual")
    check(all((r["stats"]["iters"], f"{r['stats']['rel_res']:.4e}") == EAGER_F64_GRID
              for r in runs), f"float64 sphere52k-128 repeats the eager loops' {EAGER_F64_GRID}")
    check(len({r["phi"] for r in runs}) == 1 and bool(np.isfinite(res.phi).all()),
          "the float64 solves give one finite phi")
    check(band <= ANALYTIC_BAND, "float64 analytic rel-L2 within 10% of the JAX package")
    check(rel_ref <= FAST_TIER_REL_L2_MAX, "float64 phi within 1e-5 of phase 8's reference")
    check(all(r["f64"] == (2, 0, 0) and r["f32"] == 0 and r["k2"] == 0 for r in runs),
          "every float64 grid solve launched float64 K1 twice, no float32 K1 and no K2")
    per_path["grid"] = dict(launches=sum(r["f64"][0] for r in runs))
    stencil_path("sphere52k-128 float64 host-projected", [r["stats"] for r in runs],
                 res.grid.n, "hostproj", False)

    # --- (a, continued) K1 at the main path's two launches
    cached = next(iter(solver._impl._cache.values()))
    plan = next(v for v in cached.values() if isinstance(v, DeviceShellPlan))
    pts, vecs = cached["points"], cached["vectors"]
    lam = main["lam"]
    S = int(pts.shape[0])
    errs, unit = [], 0.0
    for q in (plan.shell_pos, plan.coarse_pos):
        got = yk.yukawa_field_cuda(q, pts, vecs, lam)
        ref = yk.yukawa_field_torch(q, pts, vecs, lam)
        torch.cuda.synchronize()
        errs.append((row_rel(got, ref), (got - ref).abs().max().item()))
        unit = max(unit, (torch.linalg.vector_norm(got, dim=1) - 1).abs().max().item())
        del got, ref
    err_main = max(e[0] for e in errs)
    print(f"  float64 kernel vs plain at the main path's launches: shell Q="
          f"{plan.shell_pos.shape[0]} max err per row {errs[0][0]:.3e}, coarse Q="
          f"{plan.coarse_pos.shape[0]} {errs[1][0]:.3e} (tol {F64_ROW_RTOL:g}); | |Y|-1 | <= "
          f"{unit:.1e}")
    check(err_main <= F64_ROW_RTOL and unit <= 1e-14,
          "float64 kernel within 1e-12 per row at the main path's launches")

    def both(fn, q_s, q_c, p, v, reps):
        return time_ms(lambda: (fn(q_s, p, v, lam), fn(q_c, p, v, lam)), reps)

    t64, t32 = [], []
    for _ in range(2):  # turns: float64, float32, float32, float64
        t64.append(both(yk.yukawa_field_cuda, plan.shell_pos, plan.coarse_pos, pts, vecs, 3))
        t32.append(both(yk.yukawa_field_cuda, main["plan"].shell_pos, main["plan"].coarse_pos,
                        main["points"], main["vectors"], 3))
        t32.append(both(yk.yukawa_field_cuda, main["plan"].shell_pos, main["plan"].coarse_pos,
                        main["points"], main["vectors"], 3))
        t64.append(both(yk.yukawa_field_cuda, plan.shell_pos, plan.coarse_pos, pts, vecs, 3))
    plain_ms = both(yk.yukawa_field_torch, plan.shell_pos, plan.coarse_pos, pts, vecs, 1)
    pairs = (int(plan.shell_pos.shape[0]) + int(plan.coarse_pos.shape[0])) * S
    fp64_rate = SMS * FP64_LANES * float(smi_query("clocks.max.sm")) * 1e6
    sass = sass_fp64_per_pair()
    per_pair = sass[0] if sass else FP64_FLOOR_PER_PAIR
    bound_ms = pairs * per_pair / fp64_rate * 1e3
    ms = statistics.median(t64)
    print(f"  float64 kernel {ms:.3f} ms (turns {[round(t, 3) for t in t64]}) against float32 "
          f"{statistics.median(t32):.3f} ms (turns {[round(t, 3) for t in t32]}), "
          f"{ms / statistics.median(t32):.2f}x; plain float64 {plain_ms:.1f} ms; {pairs} pairs")
    if sass:
        print(f"  FP64 instructions a pair from the SASS: {sass[0]:.2f} "
              f"({', '.join(f'{k} {v:g}' for k, v in sass[1].items())}; the stage loop's body "
              f"evaluates {sass[2]} pairs), plus one MUFU.RSQ64H")
    else:
        print(f"  FP64 instructions a pair: not measured (no cuobjdump); the bound takes the "
              f"{FP64_FLOOR_PER_PAIR} arithmetic operations every float64 pair needs")
    print(f"  FP64 bound {bound_ms:.3f} ms ({SMS} SMs x {FP64_LANES} lanes at the maximum SM "
          f"clock, {fp64_rate:.3e} instructions/s); the kernel at {100 * bound_ms / ms:.1f}% "
          f"of it ({smi})")
    entry = dict(max_abs_err=max(e[1] for e in errs), max_row_rel_err=max(worst, err_main),
                 ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                 fp64_per_pair=sass[0] if sass else None, f32_ms=statistics.median(t32))

    # --- (c) the 16^3 icosphere at solver_tol=1e-12 against the host oracle
    ico = make_icosphere(2)
    o_ico = SignedHeatOptions(dtype="float64", refine_steps=0, solver_tol=1e-12,
                              solver_maxiter=20000, disk_cache=False)
    ico_solver = SignedHeatSolver("grid", device=dev)
    STOP_PATHS["icosphere-16, CG float64"] = (ico_solver, ico, o_ico)
    (r_ico,), res_ico = on_card(ico_solver, ico, o_ico)
    rel_oracle = rel(res_ico.phi, oracle.solve_grid(ico, o_ico).phi)
    print(f"  icosphere {res_ico.grid.n}^3, solver_tol 1e-12: tier {r_ico['stats']['tier']}, "
          f"iters {r_ico['stats']['iters']}, rel_res {r_ico['stats']['rel_res']:.3e}; rel-L2 vs "
          f"the host oracle {rel_oracle:.3e} (limit {F64_ORACLE_REL_L2_MAX:g})")
    check(rel_oracle <= F64_ORACLE_REL_L2_MAX and r_ico["f64"] == (1, 0, 0),
          "float64 16^3 within 1e-6 of the host oracle, K1 float64 once")
    per_path["grid_icosphere16"] = dict(launches=r_ico["f64"][0])

    # --- (d) the tet domain; (e) the meshes.  A temporary disk cache lets
    # the CPU solves and the mesh solvers read the card's bunny_dec artifact
    bunny = read_geometry(BUNNY)
    b64 = SignedHeatOptions(dtype="float64", disk_cache=True)
    mesh4 = device_mesh(devices=[dev] * 4)
    mesh22 = device_mesh(devices=[dev] * 4, n_slices=2)
    saved = os.environ.get("SHM3D_CACHE_DIR")
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["SHM3D_CACHE_DIR"] = tmp
        try:
            tet = {}
            for name, o in (("CR", b64), ("vertex", b64.with_(use_crouzeix_raviart=False))):
                card_runs, card = on_card(SignedHeatSolver("tet", device=dev), bunny, o)
                t0 = time.perf_counter()
                cpu_solver = SignedHeatSolver("tet", device="cpu")
                cpu = cpu_solver.compute_distance(bunny, o)
                tet[name] = (card_runs[0], card, dict(cpu_solver.last_stats), cpu,
                             time.perf_counter() - t0)
            with eager_allowed():  # the row-split solves stay eager
                mesh_tet = [on_card(SignedHeatSolver("tet", mesh=m), bunny, b64)
                            for m in (mesh4, mesh22)]
        finally:
            if saved is None:
                del os.environ["SHM3D_CACHE_DIR"]
            else:
                os.environ["SHM3D_CACHE_DIR"] = saved
    for name, (r, card, cst, cpu, cpu_s) in tet.items():
        rs = r["stats"]
        rel_cpu = rel(card.phi, cpu.phi)
        print(f"  bunny_dec {name} (float64, {card.mesh.n_vertices} vertices): card {r['s']:.3f} s, "
              f"{rs['step3_path']}, iters {rs['iters']}, residual {rs.get('residual')}, K1 float64 "
              f"{r['f64'][0]}, K2 {r['k2']}; this machine's CPU {cpu_s:.3f} s, iters "
              f"{cst['iters']}, residual {cst.get('residual')}; rel-L2 card vs CPU {rel_cpu:.3e}, "
              f"max |diff| / max |phi| {np.abs(card.phi - cpu.phi).max() / np.abs(cpu.phi).max():.3e} "
              f"(limit {F64_CPU_REL_L2_MAX:g})")
        check(rel_cpu <= F64_CPU_REL_L2_MAX and r["f64"] == (1, 0, 0) and r["k2"] == 0
              and r["f32"] == 0, f"bunny_dec {name} in float64 on the card near the CPU's")
    per_path["tet_bunny"] = dict(launches=sum(v[0]["f64"][0] for v in tet.values()))
    check(tet["CR"][0]["stats"]["iters"] == EAGER_F64_BUNNY_CR_ITERS,
          f"bunny_dec CR in float64 repeats the eager loops' {EAGER_F64_BUNNY_CR_ITERS} iterations")

    knot = read_geometry(KNOT)
    k_solver = SignedHeatSolver("tet", device=dev)
    k_opts = SignedHeatOptions(dtype="float64", disk_cache=False)
    (r,), kres = on_card(k_solver, knot, k_opts)
    ks = r["stats"]
    print(f"  knot_dec CR in float64 (cold): {r['s']:.3f} s, iters {ks['iters']}, final "
          f"residual {ks['residual']:.3e} (limit {F64_KNOT_RESIDUAL_MAX:g}), projection "
          f"{ks['proj_iters']} iters {ks['proj_residual']:.3e}, K1 float64 {r['f64'][0]}, K2 "
          f"{r['k2']}, mem_peak_mb {ks['mem_peak_mb']:.1f}, phases {json.dumps(ks['phases'])} "
          f"({smi})")
    check(ks["step3_path"] == "crouzeix-raviart" and ks["residual"] <= F64_KNOT_RESIDUAL_MAX
          and ks["proj_residual"] <= PROJ_RESIDUAL_MAX and r["f64"] == (1, 0, 0)
          and r["k2"] == 0, "knot_dec CR in float64: residuals, K1 float64 once, no K2")
    check(ks["iters"] == EAGER_F64_KNOT_ITERS,
          f"knot_dec CR in float64 repeats the eager loops' {EAGER_F64_KNOT_ITERS} iterations")
    check_bands(kres, dict(min=JAX_PHI_MIN, max=JAX_PHI_MAX, mean_abs=JAX_PHI_MEAN_ABS,
                           src_mean_abs=JAX_PHI_MEAN_ABS_SRC), F64_PHI_BANDS,
                "knot_dec CR in float64")
    per_path["tet_knot"] = dict(launches=r["f64"][0])

    # (e) the grid on 1 x 4 and 2 x 2 from the one device's discretization
    grid_mesh = []
    for m in (mesh4, mesh22):
        ms_solver = tgrid.GridSolver(mesh=m)
        ms_solver._cache.update(solver._impl._cache)
        grid_mesh.append(on_card(ms_solver, geom, o64))
    (g4,), r4 = grid_mesh[0]
    (g22,), r22 = grid_mesh[1]
    rel_g = rel(r4.phi, res.phi)
    print(f"  grid on 1 x 4: {g4['s']:.3f} s, iters {g4['stats']['iters']} (one device "
          f"{st['iters']}), K1 float64 {g4['f64'][0]}; 2 x 2 {g22['s']:.3f} s; 1 x 4 = 2 x 2 bit "
          f"for bit {g4['phi'] == g22['phi']}; Y bitwise one device's {torch.equal(r4.Y, res.Y)}; "
          f"rel-L2 vs one device {rel_g:.3e} (limit {F64_MESH_REL_L2_MAX:g})")
    check(g4["phi"] == g22["phi"] and torch.equal(r4.Y, res.Y) and rel_g <= F64_MESH_REL_L2_MAX
          and g4["stats"]["mesh"]["step3"] == "z-slabs",
          "the float64 grid on the meshes: one phi, one device's Y, near one device's phi")
    check(all(r["f64"] == (8, 0, 0) for r in (g4, g22)), "K1 float64 on 4 row blocks, twice")
    per_path["grid_mesh"] = dict(launches=g4["f64"][0] + g22["f64"][0])
    (t4,), tr4 = mesh_tet[0]
    (t22,), tr22 = mesh_tet[1]
    one_cr = tet["CR"][1]
    rel_t = rel(tr4.phi, one_cr.phi)
    print(f"  bunny_dec CR on 1 x 4: {t4['s']:.3f} s, iters {t4['stats']['iters']} (one device "
          f"{tet['CR'][0]['stats']['iters']}), K1 float64 partial + merge {t4['f64'][1:]}; "
          f"2 x 2 {t22['s']:.3f} s; 1 x 4 = 2 x 2 bit for bit {t4['phi'] == t22['phi']}; rel-L2 "
          f"vs one device {rel_t:.3e}, max |diff| / max |phi| "
          f"{np.abs(tr4.phi - one_cr.phi).max() / np.abs(one_cr.phi).max():.3e} "
          f"(limit {F64_TET_MESH_REL_L2_MAX:g}) ({smi})")
    check(t4["phi"] == t22["phi"] and rel_t <= F64_TET_MESH_REL_L2_MAX
          and all(r["f64"] == (0, 16, 4) and r["k2"] == 0 for r in (t4, t22)),
          "bunny_dec CR in float64 on the meshes: one phi, the ring's float64 kernels")
    per_path["tet_ring"] = dict(launches=sum(sum(r["f64"][1:]) for r in (t4, t22)))

    # --- (f) the CLI
    with tempfile.TemporaryDirectory() as tmp:
        phi_path = os.path.join(tmp, "phi.npy")
        cmd = [sys.executable, "-m", "shm3d_torch.cli", BUNNY, "--grid", "--dtype", "float64",
               "--device", "cuda", "--no-disk-cache", "--export-phi", phi_path, "--json"]
        t0 = time.perf_counter()
        out = subprocess.run(cmd, capture_output=True, text=True, cwd=REPO, timeout=600,
                             env=dict(os.environ, PYTHONPATH=REPO))
        check(out.returncode == 0, f"the float64 CLI exits 0 ({out.stderr[-1500:]})")
        phi = np.load(phi_path)
    print(f"  cli: {' '.join(cmd[1:])}: {time.perf_counter() - t0:.2f} s, summary "
          f"{out.stdout.strip().splitlines()[-1]}")
    check(phi.dtype == np.float64 and bool(np.isfinite(phi).all()),
          "the float64 CLI wrote a finite phi on the card")
    print(f"  phase 20 {time.perf_counter() - t_phase:.1f} s; float64 K1 launches per path "
          f"{ {k: v['launches'] for k, v in per_path.items()} }")
    entry.update(launches=sum(v["launches"] for v in per_path.values()), per_path=per_path)
    return entry

def expected_graph_launches(st) -> tuple:
    """(graph launches, host reads of the Krylov stop state) of a warm
    graphed solve, from its stats: on the grid one a stage (Steps 1-2, the
    divergence on the exact paths, the mean shift); each Krylov solve its
    setup graph, its chunk graph (MINRES two: iteration 0, then the loop)
    and one host read (the grid's projected CG, the primary or each
    correction solve; the tet paths' face or vertex solves, then the CR
    projection's); three an iteration of the grid's host-projected loop
    (the host-projected tier's solves, the subsampled tier's corrections);
    one a chunk of wavefront sweeps."""
    from shm3d_torch.ops.wavefront import CHECK_EVERY

    solves, loops, stages = 0, 0, 0
    if st["step3_path"] in ("crouzeix-raviart", "vertex"):
        solves = len(device_solves(st))
    elif "wavefront_sweeps" in st:
        stages, loops = 2, -(-st["wavefront_sweeps"] // CHECK_EVERY)
    else:
        stages = 3
        hostproj = st["tier"] == "host-projected"
        if st["step3_path"] == "minres-kkt":
            loops += 1  # iteration 0's chunk graph
            solves += 1
        elif hostproj:
            loops += 3 * st["iters"]
        else:
            solves += 1
        for k in st.get("correction_iters", []):
            if hostproj or st["tier"] == "subsampled":
                loops += 3 * k
            else:
                solves += 1
    return stages + loops + 2 * solves, solves


def graph_stats(st) -> dict:
    """What a graphed solve repeats bit for bit: GRAPH_STAT_KEYS and the
    host-projected loops' Gram-solve counts."""
    out = {k: st.get(k) for k in GRAPH_STAT_KEYS}
    for k in ("host_loop", "correction_host_loop"):
        out[k] = (st.get(k) or {}).get("gram_solves")
    return out


def launch_profile(fn) -> dict:
    """One solve under torch.profiler with device activity, which records the
    host's CUDA API calls too, read from the profiler's raw events (building
    its event tree for ~300k events would take longer than the solve): the
    kernel events and their time, the wall time, the host's kernel launch
    calls (cudaLaunchKernel, cuLaunchKernel) and graph launch calls
    (cudaGraphLaunch), and the lengths of the runs of graph launches with
    no kernel launch between them, in host order."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.profiler.kineto_results.events()
    kernel_ns, n_kernels, host = 0, 0, []
    for e in events:
        name = e.name()
        if str(e.device_type()).endswith("CUDA"):
            if not name.startswith(("Memcpy", "Memset")):
                n_kernels += 1
                kernel_ns += e.duration_ns()
        elif "LaunchKernel" in name or "GraphLaunch" in name:
            host.append((e.start_ns(), "GraphLaunch" in name))
    host.sort()
    runs, run = [], 0
    for _, graph in host:
        if graph:
            run += 1
        elif run:
            runs.append(run)
            run = 0
    if run:
        runs.append(run)
    n_graph = sum(1 for _, graph in host if graph)
    return dict(kernels=n_kernels, kernel_ms=kernel_ns / 1e6, wall_ms=wall_ms,
                launch_calls=len(host) - n_graph, graph_calls=n_graph, graph_runs=runs)


@contextlib.contextmanager
def recorded_stop_inputs():
    """The first ``krylov.cg`` or ``krylov.minres`` call in the block (an
    eager solve): its keyword arguments (tol, maxiter, rhs_mnorm, stall
    window), and what its host stop test reads, copied as computed: cg's
    ``krylov.dot`` values (r.z, b . M b, then p.Ap and r.z an iteration),
    minres's (phibar, beta) pairs (``torch.stack`` in krylov: the start's,
    then one an iteration)."""
    from shm3d_torch.solve import krylov

    rec = {"dots": [], "stacks": [], "on": False}
    cg, minres, dot = krylov.cg, krylov.minres, krylov.dot

    class Torch:  # krylov's torch: stack records, the rest is torch
        def __getattr__(self, name):
            return getattr(torch, name)

        def stack(self, ts, *args, **kw):
            out = torch.stack(ts, *args, **kw)
            if rec["on"]:
                rec["stacks"].append(out.clone())
            return out

    def recorded_dot(a, b):
        out = dot(a, b)
        if rec["on"]:
            rec["dots"].append(out.clone())
        return out

    def first(loop, kind):
        def run(matvec, b, **kw):
            if "kind" in rec:
                return loop(matvec, b, **kw)
            rec.update(kind=kind, kw=kw, on=True)
            try:
                return loop(matvec, b, **kw)
            finally:
                rec["on"] = False
        return run

    krylov.cg, krylov.minres = first(cg, "cg"), first(minres, "minres")
    krylov.dot, krylov.torch = recorded_dot, Torch()
    try:
        yield rec
    finally:
        krylov.cg, krylov.minres, krylov.dot, krylov.torch = cg, minres, dot, torch


def stop_case(stop, dev, name, solver, geom, opts) -> dict:
    """One eager solve recorded (``recorded_stop_inputs``), then the stop
    kernel and its plain version on the recorded inputs, one call an
    iteration from the start's: the whole stop state and the predicate
    compared bit for bit after every call, and the iteration at which the
    plain version stops against the solve's."""
    with recorded_stop_inputs() as rec, eager_loops():
        solver.compute_distance(geom, opts)
    kw = rec["kw"]
    if rec["kind"] == "cg":
        dots = rec["dots"]
        given = kw.get("rhs_mnorm") is not None
        rz0, bmb = dots[0], None if given else dots[1]
        seq = [(rz,) for rz in dots[(2 if given else 3)::2]]
        start_args, dtype = (rz0, bmb), rz0.dtype
        window = kw.get("stall_window") or kw["maxiter"] + 1
        params = stop.params(kw["tol"], kw["maxiter"], window, torch.finfo(dtype).tiny,
                             float(kw["rhs_mnorm"]) if given else None)
        run_cuda = lambda rz, st, go, s: stop.cg_stop_cuda(rz, None, st, go, s)
        run_plain = lambda rz, st, go, s: stop.cg_stop_torch(rz, None, st, go, s)
        start_cuda = lambda st, go: stop.cg_stop_cuda(rz0, bmb, st, go, True)
        start_plain = lambda st, go: stop.cg_stop_torch(
            rz0.cpu(), None if bmb is None else bmb.cpu(), st, go, True)
    else:
        pairs = rec["stacks"]
        dtype = pairs[0].dtype
        ref = kw.get("rhs_mnorm")
        ref = pairs[0][1] if ref is None else torch.as_tensor(ref, dtype=dtype, device=dev)
        seq = [(p[0], p[1]) for p in pairs[1:]]
        params = stop.params(kw["tol"], kw["maxiter"], 0, torch.finfo(dtype).tiny)
        run_cuda = lambda pb, bt, st, go, s: stop.minres_stop_cuda(pb, bt, None, st, go, s)
        run_plain = lambda pb, bt, st, go, s: stop.minres_stop_torch(pb, bt, None, st, go, s)
        start_cuda = lambda st, go: stop.minres_stop_cuda(pairs[0][0], pairs[0][1], ref, st,
                                                          go, True)
        start_plain = lambda st, go: stop.minres_stop_torch(
            pairs[0][0].cpu(), pairs[0][1].cpu(), ref.cpu(), st, go, True)
    iters = len(seq)
    sd, gd = stop.new_state(dev)
    sh, gh = stop.new_state("cpu")
    for s in (sd, sh):
        s[:params.shape[0]] = params
    start_cuda(sd, gd)
    start_plain(sh, gh)
    same, stopped, worst = True, None, 0.0
    for i, args in enumerate(seq + seq[-1:]):
        same &= torch.equal(sd.cpu().nan_to_num(-1.0), sh.nan_to_num(-1.0)) and \
            bool(gd) == bool(gh)
        worst = max(worst, float((sd.cpu() - sh).abs().nan_to_num(0.0).max()))
        if not bool(gh):
            stopped = i
            break
        run_cuda(*args, sd, gd, False)
        run_plain(*(a.cpu() for a in args), sh, gh, False)
    case = dict(kind=rec["kind"], dtype=str(dtype).replace("torch.", ""), iters=iters,
                stopped=stopped, bitwise=same, max_abs_err=worst)
    check(same and stopped == iters,
          f"{name}: the {rec['kind']} stop kernel ({case['dtype']}) repeats its plain version "
          f"bit for bit on the solve's {iters} iterations' inputs and stops where the solve "
          f"stopped ({stopped})")
    return case


def start_kernel_case(stop, dev) -> dict:
    """The chunk graphs' start kernel against its plain version
    (``stop.chunk_start_torch``): a chunk graph whose body adds 1 to a
    counter and runs the CG stop kernel (on r.z = 1 to a maxiter of 3)
    runs its body as the plain condition says, for go false and true, a
    WHILE node (to the stop) and an IF node (once).  Then timed: a launch
    of the WHILE graph with go false (the start kernel and the node's
    evaluation) against the plain version's host read.  Launches made here
    compare; they are not counted."""
    from shm3d_torch.solve import graphs

    count = torch.zeros((), dtype=torch.int64, device=dev)
    rz = torch.ones((), device=dev)
    fresh = torch.zeros(stop.NSLOTS, dtype=torch.float64)
    fresh[:5] = stop.params(0.0, 3, 1 << 30, 1e-38)
    worst, runs, graphs_kept = 0, [], {}
    for loop in (True, False):
        st, go = stop.new_state(dev)
        chunk = stop.CondGraph(dev, loop)
        body = torch.cuda.CUDAGraph(keep_graph=True)
        cond = stop.chunk_condition(chunk.handle) if loop else contextlib.nullcontext()
        with graphs.LaunchCounts().recording(), cond, torch.cuda.graph(body):
            count.add_(1)
            stop.cg_stop_cuda(rz, None, st, go, False)
        chunk.build(body.raw_cuda_graph(), go)
        for g in (False, True, False, True):
            count.zero_()
            st.copy_(fresh)
            go.fill_(g)
            want = (3 if loop else 1) if stop.chunk_start_torch(go) else 0
            chunk.launch(torch.cuda.current_stream(dev))
            torch.cuda.synchronize()
            got = (int(count), int(st[stop.K].item()))
            runs.append((loop, g, want, got))
            worst = max(worst, abs(got[0] - want), abs(got[1] - want))
        graphs_kept[loop] = (chunk, body, st, go)
    check(worst == 0, f"the chunk start kernel: the bodies run as its plain version's "
                      f"condition says ({runs})")
    chunk, _, st, go = graphs_kept[True]
    go.fill_(False)
    stream = torch.cuda.current_stream(dev)
    ms = time_ms(lambda: chunk.launch(stream), 200)
    plain_ms = time_ms(lambda: stop.chunk_start_torch(go), 200)
    return dict(max_abs_err=float(worst), ms=ms, plain_ms=plain_ms,
                bound_ms=1 / HBM_BYTES_S * 1e3, runs=runs)


def stop_kernel_phase(smi, dev, launches, start_launches) -> list:
    """Phase 21: the Krylov stop kernel (csrc/krylov_stop.cu) against its
    plain version bit for bit on the inputs recorded from eager solves
    (``STOP_PATHS``: CG in float32 on the main path and knot_dec CR, in
    float64 on the 16^3 icosphere; MINRES in float32 at 200 iterations):
    the whole stop state and the predicate after every call, and the stop
    at the solve's iteration; the chunk graphs' start kernel against its
    plain version; then timed, a launch of each instantiation in a graph of
    200 against the plain version's call.  Returns their kernels-line
    entries."""
    from shm3d_torch.solve import graphs, stop

    t_phase = time.perf_counter()
    cases = {name: stop_case(stop, dev, name, *path) for name, path in STOP_PATHS.items()}
    worst = max(c["max_abs_err"] for c in cases.values())
    start = start_kernel_case(stop, dev)
    # device time a launch as the chunk graphs run it: 200 launches captured
    # into one graph (noted, not counted: they compare, the main path counts)
    per_kind = {}
    reps = 200
    for kind, dtype in (("cg", torch.float32), ("cg", torch.float64),
                        ("minres", torch.float32)):
        one = torch.ones((), dtype=dtype, device=dev)
        sd, gd = stop.new_state(dev)
        sd[:5] = stop.params(1e-30, 1 << 30, 1 << 30, 1e-38)
        if kind == "cg":
            call = lambda: stop.cg_stop_cuda(one, None, sd, gd, False)
            plain = lambda: stop.cg_stop_torch(one, None, sd, gd, False)
        else:
            call = lambda: stop.minres_stop_cuda(one, one, None, sd, gd, False)
            plain = lambda: stop.minres_stop_torch(one, one, None, sd, gd, False)
        graph = torch.cuda.CUDAGraph()
        with graphs.LaunchCounts().recording():
            call()
            torch.cuda.synchronize()
            with torch.cuda.graph(graph):
                for _ in range(reps):
                    call()
            ms = time_ms(graph.replay, 20) / reps
            eager_us = host_us(call, 500)
        plain_ms = time_ms(plain, 200)
        per_kind[f"{kind}_{str(dtype).replace('torch.', '')}"] = dict(
            ms=ms, eager_host_us=eager_us, plain_ms=plain_ms)
    # bytes: r.z (MINRES phibar and beta) read, the stop state read and
    # written, the predicate written
    nbytes = 8 + 2 * 8 * stop.NSLOTS + 1
    bound_ms = nbytes / HBM_BYTES_S * 1e3
    main = per_kind["cg_float32"]
    print(f"Krylov stop kernel vs its plain version: {json.dumps(cases)}; a launch in a graph of "
          f"{reps} (launch latency bound) and an eager call's host time, against the plain "
          f"version: {json.dumps(per_kind)}; bytes bound {bound_ms * 1e6:.3f} ns; {launches} "
          f"launches on the main path ({smi})")
    print(f"chunk start kernel vs its plain version: {start['runs']} (WHILE?, go, bodies the "
          f"plain condition asks, (bodies run, k)); a launch of a chunk graph whose solve has "
          f"stopped {start['ms'] * 1e3:.3f} us, the plain host read {start['plain_ms'] * 1e3:.1f} "
          f"us; {start_launches} launches on the main path; phase "
          f"{time.perf_counter() - t_phase:.1f} s ({smi})")
    return [{"name": "krylov_stop", "route": "cuda",
             "source": "shm3d_torch/csrc/krylov_stop.cu",
             "replaces": "shm3d/solve/krylov.py:89", "launches": launches,
             "max_abs_err": worst, "ms": main["ms"], "plain_ms": main["plain_ms"],
             "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None,
             "per_path": {"cases": cases, "per_instantiation": per_kind}},
            {"name": "krylov_chunk_start", "route": "cuda",
             "source": "shm3d_torch/csrc/krylov_stop.cu",
             "replaces": "shm3d/solve/krylov.py:89", "launches": start_launches,
             "max_abs_err": start["max_abs_err"], "ms": start["ms"],
             "plain_ms": start["plain_ms"], "bound_ms": start["bound_ms"], "bound_by": "bytes",
             "library_ms": None}]


def graph_phase(smi):
    """Phase 22: each path the graphs serve (the Krylov solves, the stages,
    the host-projected loop, the wavefront), warm, against the eager loops
    on the same solver and discretization: solves in turns (eager, graph,
    graph; the 256^3 default tier, 7-9 s a solve, one eager and one
    graphed) held bit for bit equal (phi, iterations, residuals, Gram-solve
    counts, sweeps) with equal K1 and K2 launches, timed, with the host
    reads of the stop state and the graph launches as the stats predict
    (``expected_graph_launches``); then, on the paths with a chunk graph
    but the 256^3 default tier (``EAGER_PROFILED``), one profiled eager
    solve and, on the main path and the paths without a chunk
    graph (``GRAPH_PROFILED``), one profiled graphed solve: host launch
    calls, device kernel events, mem_peak_mb; the graphed solve's busy share
    estimated as the eager solve's kernel time over the graphed warm
    median."""
    from shm3d_torch.ops import yukawa as yk
    from shm3d_torch.solve import graphs, pell

    t_phase = time.perf_counter()
    summary = {}
    print(f"graphs against the eager loops ({smi})")
    for name, (solver, geom, opts, turns) in GRAPH_PATHS.items():
        runs = {"eager": [], "graph": []}
        for mode in turns:
            with eager_loops() if mode == "eager" else contextlib.nullcontext():
                k1, k2, reads = yk.KERNEL_LAUNCHES, pell.KERNEL_LAUNCHES, graphs.HOST_READS
                launched = graphs.GRAPH_LAUNCHES
                t0 = time.perf_counter()
                res = solver.compute_distance(geom, opts)
                torch.cuda.synchronize()
                st = solver.last_stats
                runs[mode].append(dict(
                    s=time.perf_counter() - t0, k1=yk.KERNEL_LAUNCHES - k1,
                    k2=pell.KERNEL_LAUNCHES - k2, reads=graphs.HOST_READS - reads,
                    launched=graphs.GRAPH_LAUNCHES - launched,
                    mem=st["mem_peak_mb"], reserved=torch.cuda.memory_reserved() / 1e6,
                    stats=graph_stats(st), expected=expected_graph_launches(st),
                    phi=hashlib.sha1(np.ascontiguousarray(res.phi).tobytes()).hexdigest()))
        # the graphed solve under the profiler only where no chunk graph runs,
        # and on the main path for its launch-call check: the profiler traces
        # the kernels inside the chunk graphs' WHILE bodies only in part, and
        # one run ended in an illegal memory access under it
        profiled = ("eager",) if name in EAGER_PROFILED else ()
        if name in GRAPH_PROFILED:
            profiled += ("graph",)
        prof = {}
        for mode in profiled:
            with eager_loops() if mode == "eager" else contextlib.nullcontext():
                prof[mode] = launch_profile(lambda: solver.compute_distance(geom, opts))
                prof[mode]["expected"] = expected_graph_launches(solver.last_stats)
            # kernel time over the unprofiled warm median
            prof[mode]["busy"] = prof[mode]["kernel_ms"] / 1e3 / statistics.median(
                r["s"] for r in runs[mode])
        e, g = runs["eager"], runs["graph"]
        # the graphed solve runs the eager solve's kernels: its busy share is
        # estimated as the eager kernel time over its warm median (the
        # profiler sees the kernels inside conditional bodies only in part,
        # so no trace of the graphed solve measures it)
        busy = (prof["eager"]["kernel_ms"] / 1e3 / statistics.median(r["s"] for r in g)
                if "eager" in prof else None)
        same = len({r["phi"] for r in e + g}) == 1 and all(
            r["stats"] == e[0]["stats"] for r in e + g)
        counts = {(r["k1"], r["k2"]) for r in e + g}
        te, tg = statistics.median(r["s"] for r in e), statistics.median(r["s"] for r in g)
        chunk_graphs = path_chunk_graphs(solver)
        nodes = [c for cg in chunk_graphs for _, c in cg.node_counts]
        print(f"  {name}: eager {[round(r['s'], 4) for r in e]} s, graph "
              f"{[round(r['s'], 4) for r in g]} s (median {te:.4f} against {tg:.4f} s, "
              f"{te / tg:.2f}x); bit for bit {same} (iters {e[0]['stats']['iters']}, graph "
              f"launches and host reads a solve {g[0]['expected']}, read {g[0]['reads']}, "
              f"Gram solves {e[0]['stats']['host_loop']} + "
              f"{e[0]['stats']['correction_host_loop']}, sweeps "
              f"{e[0]['stats']['wavefront_sweeps']}); K1, K2 launches a solve "
              f"{sorted(counts)}; conditional nodes of the chunk graphs {nodes}")
        for mode in profiled:
            p, r = prof[mode], runs[mode][0]
            print(f"    {mode}: {p['launch_calls']} kernel launch calls and {p['graph_calls']} "
                  f"graph launches from the host, {p['kernels']} device kernel events, "
                  f"{p['kernel_ms']:.1f} ms of kernel time ({p['busy']:.1%} of the unprofiled "
                  f"warm median; {p['wall_ms']:.1f} ms under the profiler); runs of graph "
                  f"launches {p['graph_runs']}; "
                  f"mem_peak_mb {r['mem']:.1f}, reserved {r['reserved']:.1f} MB")
        print(f"    graph: {g[0]['launched']} graph launches a solve (counted by the port); busy "
              f"{'not estimated' if busy is None else f'estimated {busy:.1%}'} (not measured: "
              f"the eager solve's kernel time, the same kernels, over the graphed warm median); "
              f"mem_peak_mb {g[0]['mem']:.1f}")
        check(same, f"{name}: the graphed solves repeat the eager loop's phi, iterations, "
              f"residuals, Gram solves and sweeps bit for bit")
        check(len(counts) == 1, f"{name}: equal K1 and K2 launches under both")
        check(all(r["reads"] == 0 for r in e) and all(r["reads"] == r["expected"][1] for r in g),
              f"{name}: one host read of the stop state a Krylov solve, none on the eager loops")
        check(all(c == 1 for cg in chunk_graphs for _, c in cg.node_counts),
              f"{name}: every chunk graph holds its conditional node (no fallback)")
        if "eager" in prof:
            check(prof["eager"]["graph_calls"] == 0 and prof["eager"]["launch_calls"] > 0,
                  f"{name}: the eager solve launched kernels one at a time")
        check(all(r["launched"] == r["expected"][0] for r in g)
              and all(prof[m]["graph_calls"] == prof[m]["expected"][0] for m in profiled
                      if m == "graph"),
              f"{name}: the graphed solve took its graph launches (one a stage; a setup and "
              f"a chunk graph a Krylov solve, MINRES one more; three a host-projected "
              f"iteration; one a chunk of sweeps)")
        check(all(r["launched"] == 0 for r in e), f"{name}: no graph launch on the eager loops")
        if name == "sphere52k-128 fast tier":
            check(prof["graph"]["launch_calls"] < MAIN_LAUNCH_CALLS_MAX,
                  f"a warm main-path solve makes fewer than {MAIN_LAUNCH_CALLS_MAX} kernel "
                  f"launch calls ({prof['graph']['launch_calls']})")
        summary[name] = dict(
            eager_s=[r["s"] for r in e], graph_s=[r["s"] for r in g],
            iters=e[0]["stats"]["iters"], graph_launches=g[0]["expected"][0],
            host_reads=g[0]["reads"], conditional_nodes=nodes,
            launch_calls={m: prof[m]["launch_calls"] for m in profiled},
            graph_calls=g[0]["launched"],
            kernels={m: prof[m]["kernels"] for m in profiled},
            kernel_ms={m: prof[m]["kernel_ms"] for m in profiled},
            busy_estimate=busy, mem_peak_mb=(e[0]["mem"], g[0]["mem"]))
    pools = graph_pools()
    print(f"  the graphs' private memory pools (reserved MB, from the allocator's snapshot): "
          f"{json.dumps(pools) if pools is not None else 'not measured (no pool ids)'}")
    print(f"  phase 22 {time.perf_counter() - t_phase:.1f} s; summary {json.dumps(summary)}")
    return summary


def path_caches(solver) -> list:
    """The graph caches of a solver's discretizations (the grid's, the
    tet vertex path's and the CR path's)."""
    out = []
    for cached in solver._impl._cache.values():
        caches = [cached.get("graphs"), cached.get("vertex_graphs"),
                  getattr(cached.get("cr_path"), "graphs", None)]
        out += [c for c in caches if c]
    return out


def path_chunk_graphs(solver) -> list:
    from shm3d_torch.solve import graphs

    return [g for c in path_caches(solver) for g in c.values()
            if isinstance(g, graphs.ChunkGraph)]


def graph_pools():
    """Reserved MB of each graph's private memory pool, by path and graph
    key (a Krylov solve's setup and chunk graphs share one), summed over
    the allocator's segments of that pool; None when the allocator's
    snapshot is not available or names no pools."""
    from shm3d_torch.solve import graphs

    try:  # a private API of torch's allocator: its absence is "not measured"
        segments = torch.cuda.memory._snapshot()["segments"]
    except Exception:  # noqa: BLE001
        return None
    if not all("segment_pool_id" in seg for seg in segments):
        return None
    by_pool = {}
    for seg in segments:
        pool = tuple(seg["segment_pool_id"])
        by_pool[pool] = by_pool.get(pool, 0) + seg["total_size"]

    def pool_of(g):
        if isinstance(g, graphs.ChunkGraph):
            return g.setup_graph.pool()
        if isinstance(g, graphs.StageGraph):
            return g.graph.pool()
        return g.graphs[0].pool()

    out, seen = {}, set()
    for name, (solver, *_) in GRAPH_PATHS.items():
        for cache in path_caches(solver):
            for key, g in cache.items():
                if isinstance(g, (graphs.IterationGraph, graphs.ChunkGraph, graphs.StageGraph)) \
                        and id(g) not in seen:
                    seen.add(id(g))
                    out[f"{name}: {key}"] = round(by_pool.get(tuple(pool_of(g)), 0) / 1e6, 1)
    return out


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
    from shm3d_torch.solve import ell, graphs, pell, stop

    check(os.path.dirname(os.path.abspath(shm3d_torch.__file__)) ==
          os.path.join(REPO, "shm3d_torch"), "shm3d_torch imported from this checkout")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"gpu: {smi}")
    t_start = time.perf_counter()

    def stamp(what):
        print(f"[{time.perf_counter() - t_start:.1f} s] {what} done", flush=True)
    dev = resolve_device("cuda")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]} device {torch.cuda.get_device_name(0)}")
    refuse_eager_loops(graphs)

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
    stamp("build and K1 cases")

    # --- main path ---------------------------------------------------------
    geom = make_sphere_cloud(N_POINTS)
    opts = SignedHeatOptions(dtype="float32", h_coef=H_COEF, refine_steps=0,
                             solver_maxiter=2000, step1_method="auto",
                             disk_cache=False)
    solver = SignedHeatSolver("grid", device="cuda")
    yk.KERNEL_LAUNCHES = 0
    stop.KERNEL_LAUNCHES = 0
    stop.START_LAUNCHES = 0
    t0 = time.perf_counter()
    res = solver.compute_distance(geom, opts)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    cold_stats = dict(solver.last_stats)
    warm, reads = [], []
    for _ in range(3):
        r0 = graphs.HOST_READS
        t0 = time.perf_counter()
        res = solver.compute_distance(geom, opts)
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
        reads.append(graphs.HOST_READS - r0)
    launches = yk.KERNEL_LAUNCHES
    stop_launches, start_launches = stop.KERNEL_LAUNCHES, stop.START_LAUNCHES
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
          f"constraint rows m={m_rows}, tier {stats['tier']}, tform_eps {stats['tform_eps']}, "
          f"iters {stats['iters']}, rel_res {stats['rel_res']:.3e}, "
          f"mem_peak_mb {stats['mem_peak_mb']:.1f}")
    print(f"  yukawa kernel launches during the 4 grid solves: {launches}; Krylov stop "
          f"kernel launches {stop_launches}, chunk start kernel launches {start_launches}; "
          f"host reads of the stop state a warm solve {reads}")
    check(launches > 0, "the main path launched the Yukawa kernel")
    check(stop_launches > 0, "the main path launched the Krylov stop kernel")
    check(start_launches > 0, "the main path launched the chunk start kernel")
    check(stats["step3_path"] == "projected-mg-pcg", "step 3 path")
    check(stats["tier"] == "full-row" and stats["tform_eps"] is not None,
          "full-row whitening tier at m > 8192")
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
    check((stats["iters"], f"{rel:.6e}") == EAGER_MAIN,
          f"the main path repeats the eager loops' {EAGER_MAIN[0]} iterations and rel-L2 {EAGER_MAIN[1]}")
    check_no_jax_package()
    GRAPH_PATHS["sphere52k-128 fast tier"] = (solver, geom, opts, TURNS)
    STOP_PATHS["sphere52k-128 fast tier, CG float32"] = (solver, geom, opts)
    GRAPH_PATHS["sphere52k-128 default tier"] = (solver, geom, opts.with_(refine_steps=1), TURNS)

    # --- the kernel at the main path's shapes --------------------------------
    plan = next(v for v in cached.values() if isinstance(v, DeviceShellPlan))
    pts, vecs = cached["points"], cached["vectors"]
    lam = float(np.sqrt(1.0 / (opts.t_coef * cached["spacing"] ** 2)))
    err, times = grid_k1_check(yk, plan, pts, vecs, lam, dev, smi, "main-path")
    stamp("main path")

    # --- the default tier, the roofline, the paged kernel, the tet path -----
    profile_solve("warm fast-tier grid solve", lambda: solver.compute_distance(geom, opts),
                  statistics.median(warm), smi, rounds=2, eager=True)
    tier1 = default_tier_phase(solver, geom, opts, phi, yk, smi)
    stamp("default tier")
    tri_entry = tri_gemv_phase(smi, dev, solver, geom, opts)
    stamp("packed-triangle kernel")
    mg_entry = mg_stencil_phase(smi, dev, solver, geom, opts)
    stamp("fused stencil kernels")
    check_no_jax_package()
    sfu = sfu_pairs_per_s()
    mesh_k1, ring_k1 = mesh_phase(smi, dev, sfu, geom, opts, dict(
        solver=solver, phi=phi, iters=stats["iters"], warm_median_s=statistics.median(warm),
        phi_ref=tier1["phi_ref"], default_warm_s=tier1["warm_median_s"], k1_ms=times["kernel"],
        Y=res.Y))
    stamp("mesh phase")
    check_no_jax_package()
    wavefront_k1 = wavefront_phase(smi, dev, solver, geom, opts)
    stamp("wavefront")
    hostproj_k1 = hostproj_phase(smi, dev, geom, tier1["phi_ref"])
    stamp("host-projected tier")
    grid256_k1 = grid256_phase(smi, dev, sfu, geom, tier1["analytic"])
    stamp("256^3")
    cli_phase(smi)
    stamp("CLI")
    minres_launches = minres_phase(smi, dev, solver, geom, opts, dict(
        phi=phi, Y=res.Y, analytic=rel, phi_ref=tier1["phi_ref"]))
    # the MINRES path launches K1 at the main path's shapes on the same inputs
    err_minres, times_minres = grid_k1_check(yk, plan, pts, vecs, lam, dev, smi, "MINRES path")
    stamp("MINRES on the KKT system")
    check_no_jax_package()
    ceiling = hbm_ceiling(dev, smi)
    k3_entry, _ = roofline_phase(yk, ys, plan, pts, vecs, lam, sfu, smi, dev)
    sell_cases(pell, ell, dev)
    stamp("roofline and K2 cases")
    from shm3d_torch.solve import multigrid as mg

    mg_before = mg.STENCIL_LAUNCHES
    tet_k1, tet_k2, tet_one = tet_phase(smi, dev, ceiling)
    check(mg.STENCIL_LAUNCHES == mg_before, "the tet path launches no stencil kernel")
    stamp("tet")
    vertex_k1_launches, vertex_k2 = vertex_phase(smi, dev)
    stamp("tet vertex")
    cloud_k1, cloud_k2 = cloud_phase(smi, dev)
    stamp("tet point cloud")
    bunny_k1 = upgrade_phase(smi, dev)
    stamp("greedy and mode upgrade")
    check_no_jax_package()
    tet_ring_k1, tet_mesh_k2 = tet_mesh_phase(smi, dev, sfu, tet_one)
    stamp("tet mesh phase")
    check_no_jax_package()
    k1_f64 = f64_phase(smi, dev, geom, dict(plan=plan, points=pts, vectors=vecs, lam=lam,
                                            phi_ref=tier1["phi_ref"]))
    stamp("float64 on the card")
    check_no_jax_package()
    stop_entries = stop_kernel_phase(smi, dev, stop_launches, start_launches)
    stamp("the Krylov stop kernel")
    graph_phase(smi)
    stamp("graphs against the eager loops")
    check_no_jax_package()
    # the vertex phase launches the Yukawa kernel at the tet phase's shape
    # (the same conforming mesh), the point cloud and bunny_dec at their own
    tet_k1["launches"] += vertex_k1_launches

    # Each entry covers every path that launches its kernel: launches
    # summed, the largest error, and ms, plain_ms, bound_ms (and library_ms)
    # summed over the paths' own shapes, one launch set each (Yukawa: the
    # grid's shell + coarse launches at 128^3 and at 256^3, the knot_dec barycenter launch of the
    # CR and the vertex phase, the point cloud's, bunny_dec's; sliced ELL:
    # one product of the CR face operator, of the vertex path's S H S and of
    # the point cloud's); per_path keeps them apart.  No single PyTorch call
    # computes the Yukawa field (library_ms null).
    S = int(pts.shape[0])
    grid_bound = sum(pair_bound_ms(int(qq.shape[0]) * S, int(qq.shape[0]), S, sfu)
                     for qq in (plan.shell_pos, plan.coarse_pos))
    tet_bound = pair_bound_ms(tet_k1["pairs"], tet_k1["queries"], tet_k1["sources"], sfu)
    # the wavefront and host-projected phases launch it at the main path's
    # shapes
    grid_k1 = dict(launches=launches + wavefront_k1 + hostproj_k1, max_abs_err=err,
                   ms=times["kernel"], plain_ms=times["plain"], bound_ms=grid_bound)
    tet_k1["bound_ms"] = tet_bound
    cloud_bound = pair_bound_ms(cloud_k1["pairs"], cloud_k1["queries"],
                                cloud_k1["sources"], sfu)
    cloud_k1["bound_ms"] = cloud_bound
    bunny_bound = pair_bound_ms(bunny_k1["pairs"], bunny_k1["queries"],
                                bunny_k1["sources"], sfu)
    bunny_k1["bound_ms"] = bunny_bound
    print(f"yukawa kernel vs its SFU bound: grid {grid_k1['ms']:.3f} ms vs "
          f"{grid_bound:.3f} ms, grid 256^3 {grid256_k1['ms']:.3f} ms vs "
          f"{grid256_k1['bound_ms']:.3f} ms, tet {tet_k1['ms']:.3f} ms vs {tet_bound:.3f} ms, "
          f"tet point cloud {cloud_k1['ms']:.3f} ms vs {cloud_bound:.3f} ms, bunny_dec "
          f"{bunny_k1['ms']:.3f} ms vs {bunny_bound:.3f} ms ({smi})")
    grid_minres = dict(launches=minres_launches, max_abs_err=err_minres,
                       ms=times_minres["kernel"], plain_ms=times_minres["plain"],
                       bound_ms=grid_bound)
    k1_paths = {"grid": grid_k1, "grid256": grid256_k1, "grid_mesh": mesh_k1,
                "grid_minres": grid_minres,
                "grid_ring": ring_k1, "tet": tet_k1, "tet_point_cloud": cloud_k1,
                "tet_bunny": bunny_k1, "tet_ring": tet_ring_k1}
    k2_paths = {"tet": tet_k2, "tet_vertex": vertex_k2, "tet_point_cloud": cloud_k2,
                "tet_mesh": tet_mesh_k2}
    print("sliced-ELL kernel vs its useful-bytes bound: " + ", ".join(
        f"{name} {p['ms']:.4f} ms vs {p['bound_ms']:.4f} ms ({p['launches']} launches)"
        for name, p in k2_paths.items()) + f" ({smi})")

    def total(paths, key):
        return sum(p[key] for p in paths.values())
    mg_entry["launches"] += total(STENCIL_PATHS, "launches")
    print(f"card: {smi}")
    print(json.dumps({"kernels": [{
        "name": "yukawa_field",
        "route": "cuda",
        "source": "shm3d_torch/csrc/yukawa.cu",
        "replaces": "shm3d/ops/yukawa.py:129",
        "launches": total(k1_paths, "launches"),
        "max_abs_err": max(p["max_abs_err"] for p in k1_paths.values()),
        "ms": total(k1_paths, "ms"),
        "plain_ms": total(k1_paths, "plain_ms"),
        "bound_ms": total(k1_paths, "bound_ms"),
        "bound_by": "operations",
        "library_ms": None,
        "per_path": k1_paths,
    }, {
        "name": "sell_matvec",
        "route": "cuda",
        "source": "shm3d_torch/csrc/pell.cu",
        "replaces": "shm3d/solve/pell.py:335",
        "launches": total(k2_paths, "launches"),
        "max_abs_err": max(p["max_abs_err"] for p in k2_paths.values()),
        "ms": total(k2_paths, "ms"),
        "plain_ms": total(k2_paths, "plain_ms"),
        "bound_ms": total(k2_paths, "bound_ms"),
        "bound_by": "bytes",
        "library_ms": total(k2_paths, "library_ms"),
        "per_path": k2_paths,
    }, {
        "name": "yukawa_field_f64",
        "route": "cuda",
        "source": "shm3d_torch/csrc/yukawa.cu",
        "replaces": "shm3d/ops/yukawa.py:129",
        "launches": k1_f64["launches"],
        "max_abs_err": k1_f64["max_abs_err"],
        "ms": k1_f64["ms"],
        "plain_ms": k1_f64["plain_ms"],
        "bound_ms": k1_f64["bound_ms"],
        "bound_by": "operations",
        "library_ms": None,
        "per_path": k1_f64["per_path"],
    }, k3_entry, *stop_entries, tri_entry, mg_entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
