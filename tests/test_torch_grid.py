"""The port's grid solve end to end (shm3d_torch.solvers.grid.GridSolver on
the CPU) against shm3d.solvers.grid.GridSolver on the same geometry.

- float64, fast tier (refine_steps=0): phi rel-L2 <= 1e-8 and Krylov
  iterations within +-1.  Both solve to the float64 default tolerance 1e-10
  with the same operators; what differs is summation order (and shm3d's
  float32 pin masks, which change only the preconditioner).
- float32 on the full-row whitening tier (ORTHO_GRAM_CAP patched low in both
  packages): rel-L2 <= 1e-4.  Both float32 solves stop at relative residual
  1e-5 and round differently on the way, in the Cholesky factor too.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from shm3d.solve import projection as jproj
from shm3d.solvers.grid import GridSolver as JaxGridSolver
from shm3d_torch.api import SignedHeatSolver
from shm3d_torch.config import SignedHeatOptions
from shm3d_torch.geometry.procedural import make_icosphere, make_sphere_cloud
from shm3d_torch.io.mesh_io import PointCloud
from shm3d_torch.ops.farfield import _positions_of
from shm3d_torch.solve import projection
from shm3d_torch.solvers import grid as tgrid
from torch_interop import jax_geom, jax_options

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def cloud():
    return make_sphere_cloud(2000)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _both(geom, opts):
    js, ts = JaxGridSolver(), tgrid.GridSolver(device="cpu")
    jr = js.compute_distance(jax_geom(geom), jax_options(opts))
    tr = ts.compute_distance(geom, opts)
    return js, jr, ts, tr


@pytest.mark.parametrize("case", ["icosphere16_dense", "cloud32_shell"])
def test_grid_matches_shm3d_f64(case, cloud):
    if case == "icosphere16_dense":
        geom = make_icosphere(2)
        opts = SignedHeatOptions(dtype="float64", refine_steps=0, disk_cache=False,
                                 step1_method="dense")
    else:
        geom = cloud
        opts = SignedHeatOptions(dtype="float64", h_coef=1.0, refine_steps=0,
                                 disk_cache=False, step1_method="shell")
    js, jr, ts, tr = _both(geom, opts)
    assert tr.phi.shape == jr.phi.shape == (jr.grid.n ** 3,)
    assert tr.grid.n == jr.grid.n and tr.grid.cell_size == jr.grid.cell_size
    assert tr.grid.bbox_min == jr.grid.bbox_min
    assert _rel(tr.Y.numpy(), np.asarray(jr.Y)) < 1e-10
    assert _rel(tr.phi, jr.phi) < 1e-8
    assert abs(ts.last_stats["iters"] - js.last_stats["iters"]) <= 1
    assert ts.last_stats["step3_path"] == "projected-mg-pcg"
    assert ts.last_stats["tform_eps"] is None
    if case == "cloud32_shell":
        plan = next(v for k, v in next(iter(js._cache.values())).items()
                    if isinstance(k, tuple) and k[0] == "shell_plan")
        assert ts.last_stats["shell_nodes"] == plan.shell_idx.shape[0]


def test_full_row_tier_matches_shm3d_f32(cloud, monkeypatch):
    monkeypatch.setattr(jproj, "ORTHO_GRAM_CAP", 0)
    monkeypatch.setattr(projection, "ORTHO_GRAM_CAP", 0)
    opts = SignedHeatOptions(dtype="float32", h_coef=1.0, refine_steps=0,
                             disk_cache=False, step1_method="shell")
    js, jr, ts, tr = _both(cloud, opts)
    cached = next(iter(ts._cache.values()))
    assert cached["gram"].tmat is not None and cached["gram"].bmat is None
    assert ts.last_stats["tform_eps"] == projection.TFORM_FULL_EPS
    assert tr.phi_device.dtype == torch.float32
    assert np.isfinite(tr.phi).all()
    assert _rel(tr.phi, jr.phi) < 1e-4


@pytest.mark.parametrize("tier", ["bmat_f64", "full_row_f32"])
def test_host_arrays_match_shm3d(tier, cloud, monkeypatch):
    """The port's host precompute is shm3d's, array for array, and the
    port's device cache builds from shm3d's arrays (byte-identical host
    state carried across)."""
    if tier == "full_row_f32":
        monkeypatch.setattr(jproj, "ORTHO_GRAM_CAP", 0)
        monkeypatch.setattr(projection, "ORTHO_GRAM_CAP", 0)
        opts = SignedHeatOptions(dtype="float32", h_coef=1.0, refine_steps=0)
    else:
        opts = SignedHeatOptions(dtype="float64", h_coef=1.0, refine_steps=0)
    ref = JaxGridSolver()._build_host_arrays(jax_geom(cloud), jax_options(opts))
    got = tgrid.GridSolver(device="cpu")._build_host_arrays(cloud, opts)
    assert got.keys() == ref.keys()
    for k in ref:
        assert np.asarray(got[k]).dtype == np.asarray(ref[k]).dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    dtype = torch.float32 if tier == "full_row_f32" else torch.float64
    cached = tgrid.cached_from_arrays(ref, "cpu", dtype)
    gram = cached["gram"]
    assert (gram.tmat is not None) == (tier == "full_row_f32")
    assert (gram.bmat is not None) == (tier == "bmat_f64")
    assert cached["points"].dtype == dtype


def test_analytic_sphere_sdf():
    """bench.py's analytic cross-check at 32^3, in the main path's float32:
    a unit sphere's signed distance is |x| - 1; the solve's deviation from
    it is the method's O(h) discretization error, which the port must
    reproduce to 1% of shm3d's (the float32 solves agree to ~1e-5) and
    which stays below 5%."""
    sph = make_icosphere(4, radius=1.0)
    opts = SignedHeatOptions(dtype="float32", h_coef=1.0, refine_steps=0, disk_cache=False)
    _, jr, _, tr = _both(sph, opts)
    g = tr.grid
    pos = _positions_of(np.arange(g.n ** 3, dtype=np.int64), g)
    exact = np.linalg.norm(pos.astype(np.float64), axis=1) - 1.0
    rel_t = _rel(tr.phi, exact)
    rel_j = _rel(jr.phi, exact)
    assert abs(rel_t - rel_j) <= 1e-2 * rel_j, (rel_t, rel_j)
    assert rel_t < 0.05


def test_port_solve_never_loads_jax():
    code = (
        "import sys\n"
        "import shm3d_torch\n"
        "from shm3d_torch import SignedHeatOptions, SignedHeatSolver, make_icosphere\n"
        "s = SignedHeatSolver('grid', device='cpu')\n"
        "r = s.compute_distance(make_icosphere(2), SignedHeatOptions("
        "dtype='float64', refine_steps=0, disk_cache=False))\n"
        "assert r.phi.shape == (16 ** 3,) and s.last_stats['iters'] > 0\n"
        "V, F = s.isosurface(r)\n"
        "assert V.shape[1] == 3 and F.shape[0] > 0\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n"
        "print('OK')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("OK")


@pytest.mark.parametrize("case", [
    "fast_integration", "minres_kkt", "refine_f32", "host_projected_f64",
    "beyond_full_row_cap", "tet_domain"])
def test_unported_paths_raise(case, monkeypatch):
    geom = make_icosphere(1)
    base = SignedHeatOptions(dtype="float64", refine_steps=0, disk_cache=False)
    opts = {
        "fast_integration": base.with_(fast_integration=True),
        "minres_kkt": base.with_(solver_method="minres_kkt"),
        "refine_f32": base.with_(dtype="float32", refine_steps=1),
        "host_projected_f64": base,
        "beyond_full_row_cap": base.with_(dtype="float32"),
    }.get(case)
    if case == "refine_f32":
        # the default tier is ported; the correction of a subsampled-pin
        # solve (full rows through the host-projected loop) waits for A10
        with pytest.raises(NotImplementedError, match="ROADMAP A10"):
            tgrid.GridSolver(device="cpu")._correction_solve(
                torch.zeros(8), {"pin_keep": np.arange(2)}, None, opts)
        return
    if case == "tet_domain":
        # the tet domain runs the Crouzeix-Raviart path; a point cloud takes
        # the vertex path, which is not ported
        cloud = PointCloud(geom.vertices.copy(), geom.vertices.copy())
        with pytest.raises(NotImplementedError, match="A14"):
            SignedHeatSolver("tet", device="cpu").compute_distance(cloud, base)
        return
    if case in ("host_projected_f64", "beyond_full_row_cap"):
        monkeypatch.setattr(projection, "ORTHO_GRAM_CAP", 0)
        monkeypatch.setattr(projection, "TFORM_FULL_CAP", 0)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tgrid.GridSolver(device="cpu").compute_distance(geom, opts)


def test_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        assert tgrid.GridSolver(device="cuda").device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            SignedHeatSolver("grid", device="cuda")


def test_disk_cache_roundtrip(tmp_path, monkeypatch):
    """A fresh solver reloads the operator artifacts from the port's own
    disk-cache namespace and reproduces phi."""
    monkeypatch.setenv("SHM3D_CACHE_DIR", str(tmp_path))
    geom = make_icosphere(2)
    opts = SignedHeatOptions(dtype="float64", refine_steps=0)
    r1 = tgrid.GridSolver(device="cpu").compute_distance(geom, opts)
    files = list(tmp_path.glob("*.npz"))
    assert len(files) == 1
    r2 = tgrid.GridSolver(device="cpu").compute_distance(geom, opts)
    np.testing.assert_array_equal(r2.phi, r1.phi)
    JaxGridSolver().compute_distance(jax_geom(geom), jax_options(opts))  # its own namespace
    assert len(list(tmp_path.glob("*.npz"))) == 2
