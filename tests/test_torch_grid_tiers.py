"""The grid projector's tiers past ORTHO_GRAM_CAP (shm3d_torch.solvers.grid
on the CPU) against shm3d.solvers.grid and the port's float64 oracle
(shm3d_torch.oracle.reference.solve_grid), with the caps patched low in
both packages so a 16^3 icosphere takes each tier.

- subsampled pins (float32, max_device_pins=24): the same pin rows as
  shm3d, pinned rows held and unpinned rows slack, phi within 1e-4 of
  shm3d's (both float32 solves stop at the 1e-4 floor of this tier), and
  the defect correction, which projects with all rows, within 1e-5 of the
  oracle;
- host-projected (max_device_pins=None): float64 within 1e-6 of the oracle
  and 1e-8 of shm3d with the same iterations (+-2); float32 within 1e-4 of
  shm3d;
- the fallback of a full-row factor that fails at every shift, and a disk
  round trip of a subsampled artifact.
"""

import warnings

import numpy as np
import pytest
import torch

from shm3d.solve import projection as jproj
from shm3d.solvers.grid import GridSolver as JaxGridSolver
from shm3d_torch.config import SignedHeatOptions
from shm3d_torch.geometry.procedural import make_icosphere
from shm3d_torch.oracle import reference as oracle
from shm3d_torch.solve import projection
from shm3d_torch.solvers import grid as tgrid
from shm3d_torch.utils import diskcache
from torch_interop import jax_geom, jax_options

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def ico():
    return make_icosphere(2)


@pytest.fixture
def caps(monkeypatch):
    """Patch the tier caps of both packages; ``caps(full_row=...)``."""
    def set_caps(full_row: bool = False):
        for mod in (jproj, projection):
            monkeypatch.setattr(mod, "ORTHO_GRAM_CAP", 0)
            if not full_row:
                monkeypatch.setattr(mod, "TFORM_FULL_CAP", 0)
    return set_caps


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _rows_res(u, nodes8, coeffs8):
    u = u.detach().cpu().numpy().astype(np.float64)
    return np.abs((u[np.asarray(nodes8.cpu())] * np.asarray(coeffs8, np.float64)).sum(axis=1)).max()


def test_subsampled_tier_matches_shm3d(ico, caps):
    caps()
    opts = SignedHeatOptions(dtype="float32", refine_steps=0, max_device_pins=24,
                             disk_cache=False)
    js, ts = JaxGridSolver(), tgrid.GridSolver(device="cpu")
    jr = js.compute_distance(jax_geom(ico), jax_options(opts))
    tr = ts.compute_distance(ico, opts)
    jc, tc = next(iter(js._cache.values())), next(iter(ts._cache.values()))
    assert ts.last_stats["tier"] == "subsampled"
    np.testing.assert_array_equal(tc["pin_keep"], jc["pin_keep"])
    m_full, m_pin = tc["nodes8"].shape[0], tc["pin_nodes8"].shape[0]
    assert 0 < m_pin <= 24 < m_full
    # the subsample's Cholesky factor, kept as the packed lower triangle
    tmat = tc["gram"].tmat
    nb = -(-m_pin // projection.TRI_TILE)
    assert isinstance(tmat, projection.TriFactor) and tmat.m == m_pin
    assert tmat.tiles.shape == (nb * (nb + 1) // 2, projection.TRI_TILE, projection.TRI_TILE)
    # the device solve holds the pinned rows to its float32 floor (u before
    # the mean shift); the unpinned rows keep real slack
    u = tr.u_device
    pin_res = _rows_res(u, tc["pin_nodes8"], tc["pin_coeffs8"])
    full_res = _rows_res(u, tc["nodes8"], tc["coeffs8_f64"])
    assert pin_res < 1e-3 * float(u.abs().max()), pin_res
    assert full_res > 10 * pin_res, (full_res, pin_res)
    assert _rel(tr.phi, jr.phi) < 1e-4

    # the defect correction projects with ALL rows through the host loop
    opts5 = opts.with_(refine_steps=5, refine_target=1e-10)
    got = tgrid.GridSolver(device="cpu").compute_distance(ico, opts5)
    expected = oracle.solve_grid(ico, opts5.with_(dtype="float64"))
    assert _rel(got.phi, expected.phi) < 1e-5


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_host_projected_tier_matches_shm3d(ico, caps, dtype):
    caps(full_row=True)
    opts = SignedHeatOptions(dtype=dtype, refine_steps=0, max_device_pins=None,
                             disk_cache=False)
    if dtype == "float64":
        opts = opts.with_(solver_tol=1e-12, solver_maxiter=20000)
    js, ts = JaxGridSolver(), tgrid.GridSolver(device="cpu")
    jr = js.compute_distance(jax_geom(ico), jax_options(opts))
    tr = ts.compute_distance(ico, opts)
    cached = next(iter(ts._cache.values()))
    assert ts.last_stats["tier"] == "host-projected"
    assert cached["gram"].bmat is None and cached["gram"].tmat is None
    assert cached["host_gram"] is not None
    if dtype == "float64":
        expected = oracle.solve_grid(ico, opts)
        assert _rel(tr.phi, expected.phi) < 1e-6
        assert _rel(tr.phi, jr.phi) < 1e-8
        assert abs(ts.last_stats["iters"] - js.last_stats["iters"]) <= 2
    else:
        assert _rel(tr.phi, jr.phi) < 1e-4


def test_failed_full_row_factor_falls_back_to_host_loop(ico, caps, monkeypatch):
    caps(full_row=True)
    opts = SignedHeatOptions(dtype="float32", refine_steps=0, disk_cache=False)
    monkeypatch.setattr(projection, "_device_tform", lambda *a, **k: None)
    solver = tgrid.GridSolver(device="cpu")
    with pytest.warns(UserWarning, match="host-projected"):
        got = solver.compute_distance(ico, opts)
    assert solver.last_stats["tier"] == "host-projected"
    assert solver.last_stats["tform_eps"] is None
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        ref_solver = tgrid.GridSolver(device="cpu")
        ref = ref_solver.compute_distance(ico, opts.with_(max_device_pins=None))
    assert ref_solver.last_stats["tier"] == "host-projected"
    np.testing.assert_array_equal(got.phi, ref.phi)


def test_subsampled_artifact_disk_roundtrip(ico, caps, tmp_path, monkeypatch):
    caps()
    monkeypatch.setenv("SHM3D_CACHE_DIR", str(tmp_path))
    opts = SignedHeatOptions(dtype="float32", refine_steps=1, max_device_pins=24)
    s1 = tgrid.GridSolver(device="cpu")
    r1 = s1.compute_distance(ico, opts)
    assert len(list(tmp_path.glob("*.npz"))) == 1
    key = (diskcache.geometry_content_hash(ico), opts.cache_key())
    arrays = diskcache.load(tgrid._CACHE_NS + key)
    np.testing.assert_array_equal(arrays["pin_keep"],
                                  next(iter(s1._cache.values()))["pin_keep"])
    s2 = tgrid.GridSolver(device="cpu")
    r2 = s2.compute_distance(ico, opts)
    assert s2.last_stats["tier"] == "subsampled"
    assert s2.last_stats["refine_pass_rels"] == s1.last_stats["refine_pass_rels"]
    np.testing.assert_array_equal(r2.phi, r1.phi)
