#!/usr/bin/env python3
"""Compare the sliced-ELL SpMV kernel (shm3d_torch/csrc/pell.cu) with the
paged-ELL kernel it replaced, bit for bit, on one NVIDIA GPU.

    python3 scripts/sell_vs_paged.py PAGED_CU [BUILD_DIR]

PAGED_CU is a CUDA source that exports the paged kernel's C entry point
``shm3d_pell_f32(vals, idx, meta, tile_ptr, x, y, n_tiles, device, stream)``
(one launch per segment of a PagedMat), for example the earlier
``shm3d_torch/csrc/pell.cu`` taken from git with ``git show``.  The script
builds it with nvcc into BUILD_DIR (default: a ``paged`` directory beside
PAGED_CU), then applies both kernels to the same x:

- on the knot_dec face operator, as ``SignedHeatSolver("tet")`` builds it
  (one cold solve at the library's default options): the paged kernel on
  the PagedMat that ``build_paged`` makes of the solve's Morton-ordered
  face operator, the sliced-ELL kernel on the solve's own device operator;
- on the seeded random, multiplicity and forced-segment operators of
  chip_smoke.py's sliced-ELL phase.

Both kernels sum each row as fmaf(v, x[c], a) from 0 over the row's
nonzeros in ascending column order, so y should be equal bit for bit.  It
prints, per operator, the number of rows that differ and the largest
difference, then one JSON line; exits 1 if any row differs.
"""

import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KNOT = os.path.join(REPO, "tests", "data", "knot_dec.obj")


def build_paged_library(src: str, out_dir: str) -> ctypes.CDLL:
    sys.path.insert(0, REPO)
    from shm3d_torch._build import find_nvcc

    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, "libpaged.so")
    subprocess.run([find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared",
                    "-o", so, src], check=True)
    lib = ctypes.CDLL(so)
    lib.shm3d_pell_f32.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
    lib.shm3d_pell_f32.restype = ctypes.c_int
    return lib


def paged_matvec(lib, P, x: torch.Tensor) -> torch.Tensor:
    """The paged kernel: one launch per segment, each writing its tiles."""
    PAGE = 1024
    y = torch.empty(P.n_tiles * PAGE, dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    for s in P.segs:
        err = lib.shm3d_pell_f32(
            s.vals.data_ptr(), s.idx.data_ptr(), s.meta.data_ptr(),
            s.tile_ptr.data_ptr(), x.data_ptr(),
            y.data_ptr() + s.t0 * PAGE * y.element_size(),
            int(s.tile_ptr.shape[0]) - 1, x.device.index or 0, stream)
        if err != 0:
            raise RuntimeError(f"paged kernel launch failed ({err})")
    return y[:P.n_rows]


def operators():
    """(name, host PagedMat, device SellMat) of each operator compared."""
    import scipy.sparse as sp

    from shm3d_torch import SignedHeatOptions, SignedHeatSolver
    from shm3d_torch.io.mesh_io import read_geometry
    from shm3d_torch.solve import ell, pell

    solver = SignedHeatSolver("tet", device="cuda")
    solver.compute_distance(read_geometry(KNOT), SignedHeatOptions(disk_cache=False))
    cr = next(iter(solver._impl._cache.values()))["cr_path"]
    yield "knot_dec face operator", pell.build_paged(cr._H, np.float32), cr.arrays["L"]

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
    for name, A, seg_passes in (("random 100003x90001", random, None),
                                ("multiplicity", banded(300_000, 9, 40), None),
                                ("forced segments", banded(11 * pell.PAGE + 5, 4, 600), 26)):
        saved = pell._SEG_PASSES
        if seg_passes:
            pell._SEG_PASSES = seg_passes
        try:
            P = pell.build_paged(A, np.float32)
        finally:
            pell._SEG_PASSES = saved
        yield name, P, ell.device_put_tree(P, "cuda")


def main() -> int:
    if not torch.cuda.is_available() or len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    src = os.path.abspath(sys.argv[1])
    lib = build_paged_library(
        src, sys.argv[2] if len(sys.argv) > 2 else os.path.join(os.path.dirname(src), "paged"))
    sys.path.insert(0, REPO)
    from shm3d_torch.solve import pell
    from shm3d_torch.utils import tree

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    results = []
    for name, P, S in operators():
        Pd = tree.map_arrays(lambda a: torch.as_tensor(np.ascontiguousarray(a), device="cuda"), P)
        x = torch.as_tensor(np.random.default_rng(3).standard_normal(P.n_cols),
                            dtype=torch.float32, device="cuda")
        y_paged = paged_matvec(lib, Pd, x)
        y_sell = pell.sell_matvec_cuda(S, x)
        torch.cuda.synchronize()
        differ = int((y_paged != y_sell).sum())
        diff = (y_paged - y_sell).abs().max().item()
        results.append(dict(operator=name, rows=P.n_rows, nnz=P.nnz, passes=P.n_passes,
                            rows_differing=differ, max_abs_diff=diff))
        print(f"{name}: {P.n_rows} rows, nnz {P.nnz}, {P.n_passes} passes: "
              f"{differ} rows differ, max |paged - sliced| {diff:.3e}")
    print(f"card: {smi}")
    print(json.dumps({"bitwise_equal": all(r["rows_differing"] == 0 for r in results),
                      "operators": results}))
    return 0 if all(r["rows_differing"] == 0 for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
